"""The port's token pipeline (``repro_torch.data.pipeline``) against the
JAX package's ``repro.data.pipeline``: the same bits, always.

``batch_at`` is bit-identical to the reference's for vocabularies 100 and
50,000 (over the 1,024-token bigram cap), several seeds and steps, one
host and each of two hosts; the bigram table and its constants are the
reference's; the iterator resumes at any step with the batches
``batch_at`` gives and stops its thread when closed; two hosts get
different slices of one global step, and a global batch the hosts do not
divide raises.
"""
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipeline  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402


def test_constants_and_table_are_the_references():
    assert pipeline._MAX_BIGRAM == jpipeline._MAX_BIGRAM == 1024
    assert pipeline._BIGRAM_PEAK == jpipeline._BIGRAM_PEAK
    for seed, vocab in ((0, 100), (5, 50_000)):
        np.testing.assert_array_equal(pipeline._bigram_cdf(seed, vocab),
                                      jpipeline._bigram_cdf(seed, vocab))


@pytest.mark.parametrize("vocab", [100, 50_000])
@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2)])
def test_batch_at_is_bit_identical(vocab, seed, hosts):
    host_index, n_hosts = hosts
    kw = dict(vocab=vocab, global_batch=8, seq_len=24, seed=seed,
              host_index=host_index, n_hosts=n_hosts)
    got, want = pipeline.TokenPipeline(**kw), jpipeline.TokenPipeline(**kw)
    for step in (0, 1, 7, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["tokens"].shape == (8 // n_hosts, 24)
        assert a["tokens"].max() < min(vocab, pipeline._MAX_BIGRAM)


def test_iterator_resumes_and_stops():
    p = pipeline.TokenPipeline(100, 4, 16, seed=0)
    before = threading.active_count()
    it = p.iterate(start_step=10)
    for want in (10, 11, 12):
        step, batch = next(it)
        assert step == want
        np.testing.assert_array_equal(batch["tokens"],
                                      p.batch_at(want)["tokens"])
    it.close()
    assert threading.active_count() == before


def test_hosts_get_different_slices():
    ps = [pipeline.TokenPipeline(100, 8, 16, seed=1, host_index=i, n_hosts=2)
          for i in range(2)]
    b0, b1 = ps[0].batch_at(0), ps[1].batch_at(0)
    assert b0["tokens"].shape == (4, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["targets"][:, :-1])
    with pytest.raises(ValueError, match="hosts"):
        pipeline.TokenPipeline(100, 5, 16, n_hosts=2)
