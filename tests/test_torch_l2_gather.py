"""The second pass's gather (``ops.l2_gather_rows``, ``l2_rerank.cu``'s
``l2_gather_rows_kernel``): exact distances of the masked (query, slot)
entries of per-query id rows, +inf off the mask.

Bars: on the CPU the op is the chunked plain version and equals the whole
gather summed by ``numerics.ordered_sum`` bitwise; on a card the kernel
equals its plain version bitwise on the same card tensors (the same
additions in the same order), in one launch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import numerics  # noqa: E402
from repro_torch.index import search  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)
INF = float("inf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _whole_gather(vectors, ids, qs, mask):
    """The second pass as one gather: every (query, slot) row at once,
    squares summed by ``ordered_sum``, +inf off the mask."""
    diff = vectors[ids.clamp(min=0)] - qs[:, None, :]
    d = numerics.sqrt_rn(numerics.ordered_sum(diff * diff))
    return torch.where(mask, d, INF)


def _inputs(rng, n, d, b, w, share):
    """Vectors, queries, id rows with -1 off the mask, and a mask with
    about ``share`` of its slots set."""
    vectors = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, w)) < share)
    ids = torch.from_numpy(rng.integers(0, n, (b, w)).astype(np.int64))
    return vectors, torch.where(mask, ids, -1), qs, mask


@pytest.mark.parametrize("d", [1, 7, 100, 128, 129, 960])
def test_cpu_op_is_the_whole_gather_bitwise(rng, d):
    vectors, ids, qs, mask = _inputs(rng, 500, d, 3, 211, 0.6)
    got = ops.l2_gather_rows(vectors, ids, qs, mask)
    assert torch.equal(got, _whole_gather(vectors, ids, qs, mask))
    assert torch.equal(torch.isfinite(got), mask)
    assert torch.equal(search._exact_dists_rows(vectors, ids, qs, mask), got)


def test_cpu_op_takes_an_expanded_id_row(rng):
    """RaBitQ's stragglers pass one position row expanded over the
    queries (row stride 0)."""
    vectors, _, qs, mask = _inputs(rng, 400, 32, 4, 400, 0.05)
    pos = torch.arange(400).expand(4, 400)
    got = ops.l2_gather_rows(vectors, pos, qs, mask)
    assert torch.equal(got, _whole_gather(vectors, pos.contiguous(), qs,
                                          mask))


def test_cpu_op_with_nothing_set(rng):
    vectors, ids, qs, _ = _inputs(rng, 50, 16, 2, 30, 0.5)
    mask = torch.zeros(2, 30, dtype=torch.bool)
    assert torch.equal(ops.l2_gather_rows(vectors, ids, qs, mask),
                       torch.full((2, 30), INF))


@pytest.mark.parametrize("d,aligned,plan", [
    (128, True, ops.GatherPlan(8, True, 4 * (128 + 1024 + 32 * 64))),
    (256, True, ops.GatherPlan(8, True, 4 * (256 + 1024 + 32 * 128))),
    (264, True, ops.GatherPlan(16, True, 4 * (264 + 1024 + 16 * 132))),
    (960, True, ops.GatherPlan(32, True, 4 * (960 + 1024 + 8 * 480))),
    (960, False, ops.GatherPlan(32, False, 4 * (960 + 1024 + 8 * 480))),
    (100, True, ops.GatherPlan(8, False, 4 * (100 + 1024 + 32 * 52))),
    (129, True, ops.GatherPlan(8, False, 4 * (132 + 1024 + 32 * 68))),
    (130, True, ops.GatherPlan(16, False, 4 * (132 + 1024 + 16 * 68))),
    (32, True, ops.GatherPlan(8, True, 4 * (32 + 1024 + 32 * 16))),
    (1, True, ops.GatherPlan(8, False, 4 * (4 + 1024 + 32 * 4)))])
def test_gather_plan(d, aligned, plan):
    """16-byte loads at d % 8 == 0 on aligned rows; the fewest lanes a row
    (8 at least) that take the first round's pairs at 4 (16-byte) or 8
    (4-byte) a lane; the query, the slot list and a group buffer of
    ceil(d/2) floats, each rounded up to 16 bytes."""
    assert ops._gather_plan(d, aligned) == plan


def test_gather_plan_refuses_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ops._gather_plan(20_000, True)


# ---- on the card ------------------------------------------------------------

def _on_card(cuda, vectors, ids, qs, mask, shift=False):
    """The inputs on the card; ``shift`` puts the vectors 4 bytes off a
    16-byte boundary."""
    if shift:
        flat = torch.empty(vectors.numel() + 1, device=cuda)
        v = flat[1:].view(vectors.shape)
        v.copy_(vectors)
        assert v.data_ptr() % 16 == 4 and v.is_contiguous()
    else:
        v = vectors.to(cuda)
    return v, ids.to(cuda), qs.to(cuda), mask.to(cuda)


def _check_one_launch(args):
    ops.reset_launches()
    got = ops.l2_gather_rows(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["l2_gather_rows_batch"] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    want = ref.l2_gather_rows(*args)
    assert torch.equal(torch.isfinite(got), args[3])
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 960, 100, 129, 264])
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("shift", [False, True])
def test_cuda_dense_mask_bitwise(rng, cuda, d, b, shift):
    """About 90% of 5,000 slots set, -1 ids off the mask."""
    args = _on_card(cuda, *_inputs(rng, 20_000, d, b, 5_000, 0.9), shift)
    got = _check_one_launch(args)
    cpu = [t.cpu() for t in args]
    assert torch.equal(got.cpu(), ref.l2_gather_rows(*cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 960, 100, 129])
@pytest.mark.parametrize("b", [1, 32])
def test_cuda_sparse_mask_on_an_expanded_row_bitwise(rng, cuda, d, b):
    """About 0.5% of a 1M-wide position row set, the row expanded over the
    queries (RaBitQ's stragglers)."""
    n = 1 << 20
    vectors = torch.from_numpy(
        rng.standard_normal((n, d), dtype=np.float32)).to(cuda)
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, n)) < 0.005)
    pos = torch.arange(n, device=cuda).expand(b, n)
    _check_one_launch((vectors, pos, qs.to(cuda), mask.to(cuda)))


@pytest.mark.cuda
def test_cuda_edges(rng, cuda):
    """A mask all off, all on, one set slot past the last full tile, and
    every query the same id row sliced from a wider tensor."""
    vectors, ids, qs, _ = _inputs(rng, 3000, 64, 4, 2049, 0.5)
    v, ids_c, q, _ = _on_card(cuda, vectors, ids.clamp(min=0), qs,
                              torch.zeros(1))
    for mask in (torch.zeros(4, 2049, dtype=torch.bool),
                 torch.ones(4, 2049, dtype=torch.bool),
                 torch.arange(2049).expand(4, 2049) == 2048):
        _check_one_launch((v, ids_c, q, mask.to(cuda)))
    wide = torch.from_numpy(rng.integers(0, 3000, (4, 3000))).to(cuda)
    _check_one_launch((v, wide[:, 100:2149], q, torch.ones(
        4, 2049, dtype=torch.bool, device=cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 128, 129, 264, 960])
def test_cuda_smem_layout_matches_the_plan(cuda, d):
    for aligned in (True, False):
        p = ops._gather_plan(d, aligned)
        assert ops._lib("l2_rerank").l2_gather_rows_smem_bytes(d, p.g) \
            == p.smem


@pytest.mark.cuda
def test_cuda_second_pass_in_one_launch(rng, cuda):
    """``search._exact_dists_rows`` on the card: one gather launch, no
    other kernel of the port, and the CPU's bits."""
    vectors, ids, qs, mask = _inputs(rng, 4000, 960, 8, 3000, 0.88)
    want = search._exact_dists_rows(vectors, ids, qs, mask)
    ops.reset_launches()
    got = search._exact_dists_rows(*(t.to(cuda) for t in (vectors, ids, qs,
                                                          mask)))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["l2_gather_rows_batch"] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    assert torch.equal(got.cpu(), want)
