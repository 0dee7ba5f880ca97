"""The plain reference and the comparison that decides ``correct``."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import reference, synth


def brute_force(x: np.ndarray, q: np.ndarray, k: int):
    d = np.sqrt(((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1))
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.fixture(scope="module")
def data():
    x = synth.clustered(5000, 24, 3, "cpu", n_centers=16).numpy()
    q = synth.queries_from(np.random.default_rng(4), x, 20)
    return x, q


@pytest.mark.parametrize("k", [1, 37, 400])
def test_exact_topk_equals_numpy_brute_force(data, k, monkeypatch):
    x, q = data
    monkeypatch.setattr(reference, "ROW_BLOCK", 777)   # many blocks
    monkeypatch.setattr(reference, "QUERY_BLOCK", 7)
    d, ids = reference.exact_topk(torch.from_numpy(x), torch.from_numpy(q),
                                  k)
    want_d, want_ids = brute_force(x, q, k)
    assert np.array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-12)


def test_exact_result_passes_with_recall_one(data):
    x, q = data
    k = 200
    want_d, want_ids = brute_force(x, q, k)
    out = reference.compare(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(want_ids),
                            torch.from_numpy(want_d.astype(np.float32)), k)
    assert out["recall"] == 1.0 and out["malformed"] == 0
    assert out["dist_err"] < 1e-6


def test_control_reads_above_the_limits(data):
    x, q = data
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    d, ids = reference.control_search(xt, qt, 200)
    for rows in ("all", "suffix"):
        out = reference.compare(xt, qt, ids, d, 200, exact_rows=rows,
                                exact_tol=1e-5)
        assert out["dist_err"] > 1e-4, rows


def test_malformed_rows_read_infinite(data):
    x, q = data
    k = 50
    want_d, want_ids = brute_force(x, q, k)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    for bad in ("dup", "range", "nan", "shape"):
        ids, d = want_ids.copy(), want_d.copy()
        if bad == "dup":
            ids[3, 1] = ids[3, 0]
        elif bad == "range":
            ids[3, 1] = -1
        elif bad == "nan":
            d[3, 1] = np.nan
        else:
            ids, d = ids[:, :-1], d[:, :-1]
        out = reference.compare(xt, qt, torch.from_numpy(ids),
                                torch.from_numpy(d), k)
        assert out["dist_err"] == math.inf, bad


def _suffix(x, q, ids, d, k):
    return reference.compare(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(ids), torch.from_numpy(d), k,
                             exact_rows="suffix", exact_tol=1e-5)


def test_suffix_rows_read_the_kth_row_and_the_order_after_estimates(data):
    x, q = data
    k = 60
    want_d, want_ids = brute_force(x, q, k)
    d, ids = want_d.copy(), want_ids.copy()
    d[:, :10] *= 1.05                 # estimates on a certified prefix
    d[:, :10], ids[:, :10] = d[:, 9::-1], ids[:, 9::-1]   # in any order
    out = _suffix(x, q, ids, d, k)
    assert out["dist_err"] < 1e-9
    assert out["unsorted_rows"] == 0 and out["exact_before_estimate"] == 0
    assert reference.compare(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(ids), torch.from_numpy(d),
                             k)["dist_err"] > 0.04
    # a certified row whose estimate falls on its exact distance adds one
    d[:4, 3] = want_d[:4, 6]
    assert _suffix(x, q, ids, d, k)["exact_before_estimate"] == 1


def test_an_estimate_after_exact_rows_is_counted(data):
    x, q = data
    k = 60
    want_d, want_ids = brute_force(x, q, k)
    d = want_d.copy()
    d[:, :10] *= 1.05
    d[5, 40] *= 1.001                 # row 40 of query 5 left unranked
    out = _suffix(x, q, want_ids, d, k)
    assert out["exact_before_estimate"] == 30 and out["dist_err"] < 1e-9


def test_rows_that_fall_are_counted(data):
    x, q = data
    k = 60
    want_d, want_ids = brute_force(x, q, k)
    d, ids = want_d.copy(), want_ids.copy()
    d[[2, 7], 50:52] = d[[2, 7], 51:49:-1]       # two rows swapped, each
    ids[[2, 7], 50:52] = ids[[2, 7], 51:49:-1]   # with its own id
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    out = reference.compare(xt, qt, torch.from_numpy(ids),
                            torch.from_numpy(d), k)
    assert out["unsorted_rows"] == 2 and out["dist_err"] < 1e-6
    assert _suffix(x, q, ids, d, k)["unsorted_rows"] == 2
    assert reference.compare(xt, qt, torch.from_numpy(want_ids),
                             torch.from_numpy(want_d), k)["unsorted_rows"] == 0


def test_to_tf32_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159265, 1e-20], dtype=torch.float32)
    r = reference.to_tf32(v)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0                 # a tie goes to the even mantissa
    assert r[3] == 1.0 + 2 ** -9
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())
    assert torch.allclose(r, v, rtol=2 ** -11, atol=0)


def test_query_generator_matches_the_ports_copy(data):
    from repro_torch.data import synthetic
    x, _ = data
    qa = synth.queries_from(np.random.default_rng(2), x, 10)
    qb = synthetic.queries_from(np.random.default_rng(2), x, 10)
    assert np.array_equal(qa, qb)


def test_the_corpus_is_one_mixture_from_its_seed():
    a = synth.clustered(4000, 16, 7, "cpu", n_centers=8)
    assert a.dtype == torch.float32 and a.shape == (4000, 16)
    assert torch.equal(a, synth.clustered(4000, 16, 7, "cpu", n_centers=8))
    assert not torch.equal(a, synth.clustered(4000, 16, 8, "cpu",
                                              n_centers=8))
    # eight centres at scale 2.0, points at 0.5 around them
    g = torch.Generator().manual_seed(7)
    centers = torch.randn(8, 16, generator=g) * 2.0
    near = torch.cdist(a, centers).min(1).values
    assert abs(float(near.pow(2).mean()) / 16 - 0.25) < 0.02
    cfg = {"n": 300, "d": 8, "data": {"generator": "clustered", "seed": 5,
                                      "n_centers": 4, "center_scale": 2.0,
                                      "point_scale": 0.5}}
    assert torch.equal(synth.corpus(cfg, "cpu"), synth.corpus(cfg, "cpu"))


def test_seeds_take_any_whole_number():
    for seed in (0, 2 ** 31 + 17, 2 ** 40, -5):
        synth.seeds(seed, 1).standard_normal(2)
    a = synth.seeds(2 ** 31 + 17, 1, 0).standard_normal(3)
    b = synth.seeds(2 ** 31 + 17, 1, 0).standard_normal(3)
    assert np.array_equal(a, b)
    assert synth.torch_seed(2 ** 40, 0) != synth.torch_seed(2 ** 40, 1)
    assert 0 <= synth.torch_seed(-5, 0) < 2 ** 63
