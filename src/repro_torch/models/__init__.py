"""The LM substrate of the port (``repro.models``): configs, layers,
attention, feed-forward blocks and the causal LM, for the ``dense`` and
``vlm`` families."""
