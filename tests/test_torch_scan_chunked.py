"""The batched fused PQ scan past one block's shared memory: the launch plan
that picks the chunked-LUT kernel (``ops._batch_scan_plan``,
``ops._chunked_plan``) and the LUT loads it fixes, on the CPU; on a card, ``fused_scan_chunked_kernel`` bitwise against the
plain version and the whole-LUT kernel, at the shapes of the GIST1M-width
8-bit cell (B = 32, M = 240, K = 256, d = 960) and at its edges.

No JAX here: the plain version (``kernels/ref.py``) is the yardstick, and
``tests/test_torch_search.py`` holds the searcher at 8 bits against the
JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import buffer as rb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

N_FLAT = 1_000_064          # the cells' stream: 1M lanes padded to 128
N_EW, M_BUCKETS = 256, 128  # every cell's codebook map and buckets


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(2033)


# --------------------------------------------------------------------------
# the plan (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,m_sub,k_codes,d", [
    (32, 32, 16, 128),       # clustered1m-pq.batch32
    (32, 240, 16, 960),      # clustered1m-d960-pq.batch32
    (31, 240, 16, 960), (2, 32, 16, 128), (32, 221, 256, 960)])
def test_whole_lut_shapes_keep_todays_kernel(b, m_sub, k_codes, d):
    """Every shape whose query LUT fits a block keeps fused_scan_kernel:
    one query a block, the waves of blocks the SMs hold split over the
    queries (as many as the shared memory lets an SM hold, at most
    ``FS_LIST_BLOCKS_PER_SM``)."""
    p = ops._batch_scan_plan(b, N_FLAT, m_sub, k_codes, d, N_EW, M_BUCKETS)
    smem = ops._batch_smem(m_sub, k_codes, d, N_EW, M_BUCKETS, 1)
    per_sm = min(ops.FS_LIST_BLOCKS_PER_SM, ops.SMEM_PER_SM // (smem + 1024))
    blocks = -(-ops.SMS * per_sm * ops.FS_LIST_WAVES // b)
    assert p == ops.ScanPlan(False, m_sub, blocks, smem)
    assert smem <= ops.MAX_SMEM


@pytest.mark.parametrize("m_sub,chunk", [(222, 111), (240, 128), (250, 125),
                                         (480, 160)])
def test_past_the_limit_the_lut_is_staged_in_chunks(m_sub, chunk):
    """M = 221 is the widest 8-bit LUT that fits at d = 960; from 222 on
    the plan takes the chunked kernel at one query a block, with the fewest
    chunks that fit (multiples of 16 where M is one), a bounded grid, and
    each query's LUT loaded once a block."""
    p = ops._batch_scan_plan(32, N_FLAT, m_sub, 256, 960, N_EW, M_BUCKETS)
    assert p.chunked and p.mc == chunk
    assert p.smem == ops._scan_smem(1, chunk, 256, 960, N_EW, M_BUCKETS)
    assert p.smem <= ops.MAX_SMEM
    assert ops._scan_smem(1, m_sub, 256, 960, N_EW, M_BUCKETS) > ops.MAX_SMEM
    chunks = -(-m_sub // chunk)
    assert ops._scan_smem(1, -(-m_sub // (chunks - 1)), 256, 960, N_EW,
                          M_BUCKETS) > ops.MAX_SMEM
    assert chunk % 16 == 0 or m_sub % 16
    assert p.blocks == ops.SMS * ops.FS_CHUNK_WAVES // 32 == 8


def test_chunked_grid_is_bounded_by_tiles_and_waves():
    """Blocks a query chunk: the waves of one block an SM split over the
    query chunks, at least one, never more than the lane tiles or the
    grid's second axis."""
    plan = ops._chunked_plan
    args = (240, 256, 960, N_EW, M_BUCKETS)
    assert plan(1, N_FLAT, *args).blocks == ops.SMS * ops.FS_CHUNK_WAVES
    assert plan(1000, N_FLAT, *args).blocks == 1
    assert plan(32, 3000, *args).blocks == 3        # 3 tiles of 1,024
    p = plan(7, N_FLAT, *args, mc=80)
    assert (p.mc, p.blocks) == (80, ops.SMS * ops.FS_CHUNK_WAVES
                                      // 7)
    assert p.smem == ops._scan_smem(1, 80, 256, 960, N_EW, M_BUCKETS)
    with pytest.raises(ValueError):
        plan(32, N_FLAT, 240, 256, 60_000, N_EW, M_BUCKETS)


def test_one_query_past_the_limit_takes_the_chunked_kernel():
    """The one-query kernel's block holds the whole LUT: at M = 240, K =
    256 it does not fit, and the one-query path plans the chunked kernel
    at B = 1; today's one-query shapes fit."""
    assert ops._b1_smem(240, 256, 960, N_EW, M_BUCKETS) > ops.MAX_SMEM
    assert ops._b1_smem(32, 16, 128, N_EW, M_BUCKETS) <= ops.MAX_SMEM
    assert ops._b1_smem(240, 16, 960, N_EW, M_BUCKETS) <= ops.MAX_SMEM
    p = ops._chunked_plan(1, N_FLAT, 240, 256, 960, N_EW, M_BUCKETS)
    assert p.chunked and p.blocks == ops.SMS * ops.FS_CHUNK_WAVES


@pytest.mark.parametrize("b,m_sub,k_codes,d,loads", [
    (32, 32, 16, 128, 33), (32, 240, 16, 960, 33),
    (32, 240, 256, 960, 8)])
def test_scan_lut_bytes_follow_the_plan(b, m_sub, k_codes, d, loads):
    """Each query's (M, K) fp32 LUT is staged once in each block of its
    query, so a call stages blocks x B x M x K x 4 bytes of LUT: 33 loads a
    query at the 4-bit cells' shapes; at the 8-bit cell's 8 (63 MB a
    call), against the 8 GB of a grid of 1,024 blocks a query; plain-version
    calls launch nothing."""
    p = ops._batch_scan_plan(b, N_FLAT, m_sub, k_codes, d, N_EW, M_BUCKETS)
    assert p.blocks == loads
    if p.chunked:
        assert p.blocks * b * m_sub * k_codes * 4 < 64e6
        assert ops.MAX_TILES * b * m_sub * k_codes * 4 > 8e9
    ops.reset_launches()
    a = _inputs(np.random.default_rng(1), 3, 600, 24, 32, 256, "cpu")
    ops.fused_scan_batch(*a)
    assert set(ops.LAUNCHES.values()) == {0}


# --------------------------------------------------------------------------
# the kernel (card)
# --------------------------------------------------------------------------

def _inputs(rng, b, n, m_sub, d, k_codes, dev, density=0.0625, run=1000,
            tau=None, shift=0):
    """The batched scan's arguments: codes, rows, per-query LUTs and
    codebooks built from the plain estimate; ``valid`` in runs of ``run``
    lanes (whole clusters, as the searcher probes them) drawn at
    ``density``; ``shift`` = 1 makes codes and vectors views one element
    into their buffers (byte-wise code loads and 4-byte row loads)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if not shift:
            return t
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    codes = rng.integers(0, k_codes, (n, m_sub), dtype=np.uint8)
    vectors = rng.standard_normal((n, d), dtype=np.float32)
    runs = rng.random((b, -(-n // run))) < density
    valid = np.repeat(runs, run, axis=1)[:, :n]
    luts = (rng.random((b, m_sub, k_codes)) * 2).astype(np.float32)
    qs = rng.standard_normal((b, d), dtype=np.float32)
    est = torch.sqrt(ref.pq_adc_batch(torch.from_numpy(codes),
                                      torch.from_numpy(luts)))
    est = torch.where(torch.from_numpy(valid), est, float("inf"))
    cb = rb.build_codebook(est, k=min(max(n // 8, 8), 5000), m=M_BUCKETS)
    if tau is None:
        tau = rng.integers(0, M_BUCKETS, b)
    tau = torch.from_numpy(np.broadcast_to(tau, (b,)).astype(np.int32))
    return (put(codes), put(vectors), torch.from_numpy(valid).to(dev),
            torch.from_numpy(luts).to(dev), torch.from_numpy(qs).to(dev),
            cb.d_min.to(dev), cb.delta.to(dev), cb.ew_map.to(dev), M_BUCKETS,
            tau.to(dev))


def _same(got, want):
    """Every output equal, NaN at the same places."""
    for a, b in zip(got, want):
        if a.is_floating_point():
            na, nb = torch.isnan(a), torch.isnan(b)
            if not (torch.equal(na, nb) and torch.equal(a[~na], b[~nb])):
                return False
        elif not torch.equal(a, b):
            return False
    return True


def _chunked(args, mc=None):
    b, m_sub, k_codes = args[3].shape
    p = ops._chunked_plan(b, args[0].shape[0], m_sub, k_codes,
                          args[1].shape[1], args[7].shape[1], args[8], mc=mc,
                          sms=ops._sms(args[0].device.index))
    before = ops.LAUNCHES["fused_scan_chunked_batch"]
    out, _ = ops._scan_batch(p, *args)
    assert ops.LAUNCHES["fused_scan_chunked_batch"] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m_sub,k_codes,mc", [(48, 256, 16), (48, 256, 32),
                                              (40, 16, 16), (33, 256, 7)])
@pytest.mark.parametrize("shift", [0, 1])
def test_cuda_chunked_equals_whole_lut_and_plain(cuda, rng, m_sub, k_codes,
                                                 mc, shift):
    """At shapes both kernels take, the chunked kernel forced at each chunk
    width (M a multiple of the chunk or not, 16-byte or byte-wise code
    loads, B = 7) gives the whole-LUT kernel's and the plain version's
    outputs bit for bit."""
    args = _inputs(rng, 7, 20_001, m_sub, 96, k_codes, cuda, density=0.3,
                   run=300, shift=shift)
    want = ref.fused_scan_batch(*args)
    whole = ops.fused_scan_batch(*args)
    assert not ops._batch_scan_plan(7, 20_001, m_sub, k_codes, 96, N_EW,
                                    M_BUCKETS).chunked
    assert _same(whole, want)
    assert _same(_chunked(args, mc), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(32, 131_075), (5, 100_003)])
def test_cuda_chunked_at_the_cells_shapes(cuda, rng, b, n):
    """The 8-bit GIST1M-width cell's shapes (M = 240, K = 256, d = 960,
    the LUT in chunks of 128 and 112 sub-quantizers): the wrapper takes
    the chunked kernel, bitwise the plain version; the same at B = 5, and
    with a forced chunk of 96 sub-quantizers (96, 96, then 48)."""
    args = _inputs(rng, b, n, 240, 960, 256, cuda)
    want = ref.fused_scan_batch(*args)
    p = ops._batch_scan_plan(b, n, 240, 256, 960, N_EW, M_BUCKETS,
                             ops._sms(cuda.index))
    assert p.chunked and p.mc == 128
    ops.reset_launches()
    got = ops.fused_scan_batch(*args)
    assert ops.LAUNCHES["fused_scan_chunked_batch"] == 1
    assert ops.LAUNCHES["fused_scan_batch"] == 0
    assert _same(got, want)
    assert _same(_chunked(args, 96), want)
    assert bool(torch.isfinite(got[3]).any()) and int(got[4].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("density,tau", [(0.0, 64), (1.0, 128), (0.5, -1)])
def test_cuda_chunked_no_lane_every_lane_and_repeats(cuda, rng, density,
                                                     tau):
    """No valid lane, every lane valid and predicted, none predicted, +inf
    and NaN LUT entries, and repeated calls: bitwise the plain version."""
    args = list(_inputs(rng, 3, 50_001, 240, 960, 256, cuda, density=density,
                        tau=tau))
    args[3][0, 0, 7], args[3][1, 100, 9] = float("inf"), float("nan")
    want = ref.fused_scan_batch(*args)
    for _ in range(3):
        assert _same(ops.fused_scan_batch(*args), want)


@pytest.mark.cuda
def test_cuda_one_query_past_the_limit(cuda, rng):
    """The one-query path at M = 240, K = 256, d = 960 (the one-query
    kernel's block cannot hold the LUT): the chunked kernel at B = 1,
    bitwise the plain version, with the threshold as an int and as a
    tensor, and through the batched wrapper at B = 1."""
    a = _inputs(rng, 1, 200_003, 240, 960, 256, cuda)
    one = (a[0], a[1], a[2][0], a[3][0], a[4][0], a[5], a[6], a[7][0], a[8])
    tau = int(a[9][0])
    want = ref.fused_scan(*one, tau)
    ops.reset_launches()
    for got in (ops.fused_scan(*one, tau), ops.fused_scan(*one, a[9])):
        assert _same(got, want)
    batched = ops.fused_scan_batch(*a)
    assert _same([t[0] for t in batched], want)
    assert ops.LAUNCHES["fused_scan_chunked_batch"] == 3
    assert ops.LAUNCHES["fused_scan"] == 0
