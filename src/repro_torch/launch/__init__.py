"""Command-line entry points and step builders of the port (``repro.launch``)."""
