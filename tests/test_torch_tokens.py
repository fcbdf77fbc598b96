"""The port's token pipeline (``repro_torch.data.tokens``) against the JAX
package's: the same generator calls give the same tokens, exactly."""
import numpy as np
import pytest

from repro.data import tokens as jtokens
from repro_torch.data import tokens


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 16, 4, 0), (256_000, 8, 2, 0), (51_865, 33, 3, 7), (64, 1, 5, 2)])
def test_sample_batch_equals_reference(vocab, seq, batch, seed):
    args = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    port = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(**args))
    ref = jtokens.SyntheticCorpus(jtokens.TokenPipelineConfig(**args))
    np.testing.assert_array_equal(port.bias_idx, ref.bias_idx)
    np.testing.assert_array_equal(port.unigram, ref.unigram)
    for step in (0, 3):
        got = port.sample_batch(step, batch)
        want = ref.sample_batch(step, batch)
        assert got.dtype == want.dtype and got.shape == (batch, seq + 1)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(port.sample_batch(0, batch),
                              port.sample_batch(1, batch)) or seq == 1


@pytest.mark.parametrize("host_count", [1, 2, 4])
def test_host_slices_equal_reference(host_count):
    args = dict(vocab=64, seq_len=8, global_batch=8, seed=1)
    port = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(**args))
    ref = jtokens.SyntheticCorpus(jtokens.TokenPipelineConfig(**args))
    full = list(port.batches(steps=2))
    for h in range(host_count):
        got = list(port.batches(host_index=h, host_count=host_count,
                                steps=2))
        want = list(ref.batches(host_index=h, host_count=host_count,
                                steps=2))
        per = 8 // host_count
        for (gt, gl), (wt, wl), (ft, _) in zip(got, want, full):
            assert gt.dtype == np.int32 and gl.dtype == np.int32
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gt, ft[h * per:(h + 1) * per])
            np.testing.assert_array_equal(gt[:, 1:], gl[:, :-1])
