"""The port's kernel wrappers: plain twins against the JAX package's
oracles and interpret-mode Pallas kernels (CPU), kernels against their
twins (CUDA, marked ``cuda``; they skip without a card).

Tolerances:
  * pair_resolve -- exact (integer ids, boolean mask), on every route;
  * port_stats -- tau exact; rho bit-identical to host NumPy in f64 (the
    twin sums in NumPy's order); against the f32 Pallas kernel and its
    f32 oracle, rho agrees to 2N f32 roundings (2N * 2**-24 relative);
  * lp_terms_batch and lp_terms -- `lp_terms.rtol(M)` relative: every
    summand is >= 0, so any summation order is within (M-1) * 2**-24 of
    the exact value;
  * flash_attention (kernel against twin, card only) -- 2e-5 in f32 (the
    reference sweep's tolerance); in bf16 one bf16 rounding, 2**-7 of the
    value plus 1e-5: both compute in f32 and round once; a row no key is
    visible to is exactly zero (the twin gives the mean of v there).  The
    twin against the reference is in `tests/test_torch_attention.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import lp as ref_lp
from repro.core.coflow import port_stats as host_port_stats
from repro.kernels.event_resolve.kernel import pair_resolve_pallas
from repro.kernels.event_resolve.ref import pair_resolve_ref
from repro.kernels.lp_terms.kernel import lp_terms_batch_pallas
from repro.kernels.lp_terms.ref import lp_terms_batch_ref
from repro.kernels.port_stats.kernel import port_stats_pallas
from repro.kernels.port_stats.ref import port_stats_ref
from repro.traffic.instances import random_instance
from repro_torch.convert import from_reference
from repro_torch.core import lp as port_lp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lp_terms as lt
from repro_torch.kernels import pair_resolve as pr
from repro_torch.kernels import port_stats as ps

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _claims(G, N, seed, F=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, F, (G, N, N))
    claim = np.where(rng.random((G, N, N)) < 0.6, ids, F).astype(np.int32)
    idle = rng.random((G, N, N)) < 0.5
    return claim, idle


def _demands(M, N, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 100.0, (M, N, N)) * (rng.random((M, N, N)) < 0.5)
    return d


def _lp_inputs(B, M, P, seed):
    rng = np.random.default_rng(seed)
    Y = np.triu(rng.random((B, M, M)), 1)
    X = Y + np.tril(1 - np.swapaxes(Y, 1, 2), -1) + np.eye(M)
    return (
        X.astype(np.float32),
        rng.uniform(0, 50, (B, M, P)).astype(np.float32),
        rng.integers(0, 10, (B, M, P)).astype(np.float32),
        rng.uniform(0.01, 0.1, B).astype(np.float32),
        rng.uniform(0.0, 3.0, B).astype(np.float32),
    )


# ---------------------------------------------------------------- pair_resolve
@pytest.mark.parametrize("G,N", [(1, 1), (2, 5), (6, 9), (3, 16)])
def test_pair_resolve_plain_matches_oracles(G, N):
    claim, idle = _claims(G, N, G * 100 + N)
    got = pr.pair_resolve(torch.from_numpy(claim), torch.from_numpy(idle))
    assert got.dtype == torch.bool
    cj = jnp.asarray(claim, jnp.float32)
    ref = np.asarray(pair_resolve_ref(cj, jnp.asarray(idle)))
    pallas = np.asarray(pair_resolve_pallas(cj, jnp.asarray(idle), interpret=True)) > 0.5
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), pallas)


def test_pair_resolve_cpu_does_not_count_and_validates():
    claim, idle = _claims(2, 4, 0)
    before = pr.LAUNCHES
    pr.pair_resolve(torch.from_numpy(claim), torch.from_numpy(idle))
    assert pr.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):
        pr.pair_resolve(torch.from_numpy(claim).float(), torch.from_numpy(idle))
    with pytest.raises(ValueError, match="idle must match"):
        pr.pair_resolve(torch.from_numpy(claim), torch.from_numpy(idle[:1]))
    with pytest.raises(ValueError, match=r"\(G, N, N\)"):
        pr.pair_resolve(torch.zeros((2, 3, 4), dtype=torch.int32), torch.zeros((2, 3, 4), dtype=torch.bool))


# (G, N) on either side of the route switch (`BLOCK_PORTS` = 32) and of
# the 4-pair vector loads (N % 4), one member and the widths of the trace.
_PAIR_PLAN_CASES = [(96, 12), (8, 48), (8, 152), (2, 240), (1, 1), (1, 32), (8, 31),
                    (8, 32), (8, 33), (3000, 12), (5, 7), (1, 240)]
_PAIR_SMEM = 48 * 1024  # both routes stay within the default shared memory


@pytest.mark.parametrize("G,N", _PAIR_PLAN_CASES)
def test_pair_resolve_plan_routes_and_covers_every_row(G, N):
    """The block route up to `BLOCK_PORTS`, the cluster route past it;
    every member in exactly one block (block route), every row of a member
    in exactly one block of its cluster, no block empty, and the grid a
    multiple of the cluster size (cluster route); shared memory and threads
    within the kernel's limits.  So is every other tiling the sweep runs."""
    for sms in (1, 66, 132):
        p = pr.plan(G, N, sms)
        assert p.route == ("block" if N <= pr.BLOCK_PORTS else "cluster")
        for q in [p] + pr.tilings(G, N):
            assert q.smem <= _PAIR_SMEM and q.threads % 32 == 0 and q.threads <= 1024
            assert q.width == (q.cluster or -q.per_block)  # the C entry's argument
            if q.route == "block":
                assert q.cluster == 0 and q.per_block * N * N <= q.threads
                assert (q.grid - 1) * q.per_block < G <= q.grid * q.per_block
                continue
            assert q.per_block == 0 and 1 <= q.cluster <= pr.MAX_CLUSTER
            assert q.grid == G * q.cluster and q.grid % q.cluster == 0
            rows = np.zeros(N, dtype=int)
            for r in range(q.cluster):
                block = slice(r * q.rows, min(N, (r + 1) * q.rows))
                assert block.start < block.stop  # no empty block
                rows[block] += 1
            assert (rows == 1).all()


@pytest.mark.cuda
def test_pair_resolve_plan_dims_are_the_sources(cuda):
    """`Plan.grid`, ``threads`` and ``smem`` are what the C entry derives
    from the plan's ``width``, for every plan and tiling of the plan cases."""
    import ctypes

    from repro_torch.kernels.common import launch

    out = (ctypes.c_longlong * 3)()
    for G, N in _PAIR_PLAN_CASES:
        for q in [pr.plan(G, N, sms) for sms in (1, 66, 132)] + pr.tilings(G, N):
            launch("pair_resolve_dims", G, N, q.width, out, device=torch.device("cuda"))
            assert tuple(out) == (q.grid, q.threads, q.smem), (G, N, q)


# (G, N): every route and the shapes on either side of each switch.
_PAIR_KERNEL_CASES = [(96, 12), (8, 48), (3, 1), (8, 152), (2, 240), (1, 12), (1, 152),
                      (8, 31), (8, 32), (8, 33), (5, 7), (1, 240)]


@pytest.mark.cuda
@pytest.mark.parametrize("one_live", [False, True], ids=["all-live", "one-live"])
@pytest.mark.parametrize("G,N", _PAIR_KERNEL_CASES)
def test_pair_resolve_kernel_matches_plain(cuda, G, N, one_live):
    """Every tiling (`tilings`) and the plan's equal to the twin; with
    ``one_live`` every member but one claims nothing and idles nowhere."""
    claim, idle = _claims(G, N, G + N, F=N * N)
    if one_live:
        dead = np.arange(G) != G // 2
        claim[dead], idle[dead] = N * N, False
    c, i = torch.from_numpy(claim).to(cuda), torch.from_numpy(idle).to(cuda)
    want = pr.pair_resolve_plain(c, i)
    for p in [None] + pr.tilings(G, N):
        before = pr.LAUNCHES
        got = pr.pair_resolve(c, i, plan=p)
        torch.cuda.synchronize()
        assert pr.LAUNCHES == before + 1
        assert torch.equal(got, want), p


@pytest.mark.cuda
@pytest.mark.parametrize("N", [12, 152])
def test_pair_resolve_kernel_on_unaligned_views(cuda, N):
    """Contiguous views one element past an aligned start take the 4-byte
    loads; the result is the same."""
    claim, idle = _claims(4, N, N, F=N * N)
    c = torch.empty(claim.size + 1, dtype=torch.int32, device=cuda)[1:].view(claim.shape)
    i = torch.empty(idle.size + 1, dtype=torch.bool, device=cuda)[1:].view(idle.shape)
    c.copy_(torch.from_numpy(claim))
    i.copy_(torch.from_numpy(idle))
    for p in [None] + pr.tilings(4, N):
        got = pr.pair_resolve(c, i, plan=p)
        torch.cuda.synchronize()
        assert torch.equal(got, pr.pair_resolve_plain(c, i)), p


@pytest.mark.cuda
def test_pair_resolve_kernel_refuses_past_its_shared_memory(cuda):
    claim = torch.zeros((1, 241, 241), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 240 ports"):
        pr.pair_resolve(claim, torch.zeros_like(claim, dtype=torch.bool))


# ------------------------------------------------------------------ port_stats
@pytest.mark.parametrize("M,N", [(3, 1), (4, 3), (5, 7), (2, 8), (3, 9), (6, 16), (2, 20), (1, 130)])
def test_port_stats_plain_bit_identical_to_host(M, N):
    d = _demands(M, N, M * 1000 + N)
    rho, tau = ps.port_stats(torch.from_numpy(d))
    rho_h, tau_h = host_port_stats(d)
    assert rho.dtype == torch.float64 and tau.dtype == torch.int32
    assert rho.numpy().tobytes() == rho_h.tobytes()
    assert np.array_equal(tau.numpy(), tau_h)


@pytest.mark.parametrize("N", [129, 169, 240, 256, 257, 300, 520])
def test_port_stats_plain_bytes_past_one_recursion_level(N):
    """NumPy's pairwise recursion to its leaves of <= 128 terms: at 257
    ports and past it the rows split more than once."""
    d = _demands(2, N, N)
    rho, tau = ps.port_stats_plain(torch.from_numpy(d))
    rho_h, tau_h = host_port_stats(d)
    assert rho.numpy().tobytes() == rho_h.tobytes()
    assert np.array_equal(tau.numpy(), tau_h)


@pytest.mark.parametrize("N", [5, 9, 130])
def test_port_stats_plain_signed_zeros_as_host(N):
    """Rows and columns of -0.0 sum to +0.0, as NumPy's reduction adds its
    pairwise sum to the identity 0.0."""
    d = _demands(3, N, N)
    d[0] = -0.0
    d[1, :, 2] = -0.0
    d[2, 1, :] = -0.0
    rho, tau = ps.port_stats_plain(torch.from_numpy(d))
    rho_h, tau_h = host_port_stats(d)
    assert rho.numpy().tobytes() == rho_h.tobytes()
    assert np.array_equal(tau.numpy(), tau_h)


@pytest.mark.parametrize("M,N", [(4, 3), (3, 10), (2, 17), (2, 169)])
def test_port_stats_plain_matches_pallas_and_oracle(M, N):
    d = _demands(M, N, M + N)
    rho, tau = ps.port_stats(torch.from_numpy(d))
    tol = 2 * N * 2.0**-24
    dj = jnp.asarray(d, jnp.float32)
    for r, t in (port_stats_ref(dj), port_stats_pallas(dj, interpret=True)):
        np.testing.assert_allclose(rho.numpy().astype(np.float32), np.asarray(r), rtol=tol)
        assert np.array_equal(tau.numpy(), np.asarray(t).astype(np.int32))


def test_port_stats_validates():
    with pytest.raises(TypeError, match="float64"):
        ps.port_stats(torch.zeros((2, 3, 3), dtype=torch.float32))
    with pytest.raises(ValueError, match=r"\(M, N, N\)"):
        ps.port_stats(torch.zeros((2, 3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="unknown route"):
        ps.tiling(2, 3, "wide", 1)
    with pytest.raises(ValueError, match="at most 128 ports"):
        ps.tiling(2, 129, "small", 1)
    before = ps.LAUNCHES
    ps.port_stats(torch.zeros((2, 3, 3), dtype=torch.float64))
    assert ps.LAUNCHES == before


# (M, N): the five timed shapes, either side of the route switch
# (`SMALL_PORTS`), one matrix of one port, M not a multiple of the
# run, and the widths past one recursion level.
_PS_PLAN_CASES = [(3200, 10), (192, 48), (256, 150), (526, 150), (64, 240),
                  (8, ps.SMALL_PORTS), (8, ps.SMALL_PORTS + 1), (1, 1), (101, 10), (2, 168),
                  (3, 257), (2, 1024)]


@pytest.mark.parametrize("M,N", _PS_PLAN_CASES)
def test_port_stats_plan_routes_and_covers_every_matrix(M, N):
    """The small route up to `SMALL_PORTS`, the stream route past it; every
    matrix in exactly one block (small: runs of ``per_block``, the last one
    short and not empty; stream: one block a matrix, whole rows a slab);
    shared memory within the card's 227 KB; threads a multiple of 32.  So
    is every other tiling the sweep runs."""
    for sms in (1, 66, 132):
        p = ps.plan(M, N, sms)
        assert p.route == ("small" if N <= ps.SMALL_PORTS else "stream")
        for q in [p] + ps.tilings(M, N):
            assert q.smem <= 232_448 and q.threads % 32 == 0 and 32 <= q.threads <= 800
            if q.route == "small":
                assert q.threads <= 512 and N <= 128
                assert q.stages == 0 and 1 <= q.per_block <= M
                assert q.grid * q.per_block >= M > (q.grid - 1) * q.per_block
                covered = np.zeros(M, dtype=int)
                for b in range(q.grid):
                    covered[b * q.per_block:(b + 1) * q.per_block] += 1
                assert (covered == 1).all()
                assert q.smem == 8 * q.per_block * N * (N | 1)
                assert q.word == q.per_block | q.threads << 20
                continue
            assert q.grid == M and 1 <= q.rows <= min(N, 32) and 2 <= q.stages <= 8
            # Column owners; a row warp per 4 rows and the copies' warp.
            owners = q.threads - 32 * -(-q.rows // 4) - 32
            assert 32 <= owners <= 512 and -(-N // owners) <= 16  # columns a thread
            assert q.word == q.rows | owners << 20 | q.stages << 31


def test_port_stats_plan_takes_up_to_max_ports():
    """A plan within a block's shared memory at every width to `MAX_PORTS`."""
    for N in (ps.SMALL_PORTS + 1, 168, 169, 1024, 1025, 4096, ps.MAX_PORTS):
        p = ps.plan(4, N, 132)
        owners = p.threads - 32 * -(-p.rows // 4) - 32
        assert p.route == "stream" and p.smem <= 232_448 and -(-N // owners) <= 16


@pytest.mark.cuda
def test_port_stats_plan_dims_are_the_sources(cuda):
    """`Plan.grid`, ``threads`` and ``smem`` are what the C entry derives
    from the plan's ``word``, for every plan and tiling of the plan cases."""
    import ctypes

    from repro_torch.kernels.common import launch

    out = (ctypes.c_longlong * 3)()
    for M, N in _PS_PLAN_CASES:
        for q in [ps.plan(M, N, sms) for sms in (1, 66, 132)] + ps.tilings(M, N):
            launch("port_stats_dims", M, N, q.word, out, device=torch.device("cuda"))
            assert tuple(out) == (q.grid, q.threads, q.smem), (M, N, q)


def _demands_of(M, N, kind):
    """Demands of one ``kind``: "random" (half zero), "zeros" (matrix 0 all
    -0.0, a zero row and a zero column elsewhere), "positive" (every entry
    > 0)."""
    d = _demands(M, N, M + N)
    if kind == "zeros":
        d[0] = -0.0
        d[M // 2, :, N // 2] = 0.0
        d[M - 1, N - 1, :] = -0.0
    elif kind == "positive":
        d = np.random.default_rng(N).uniform(1e-3, 100.0, (M, N, N))
    return d


# (M, N, kind): the old cases, one port, M not a multiple of any run, the
# widths the parent refused and past one recursion level, zero and positive
# demands, either side of the route switch.
_PS_KERNEL_CASES = [(3200, 10, "random"), (192, 48, "random"), (2, 168, "random"),
                    (1, 1, "random"), (101, 10, "random"), (7, 9, "random"), (5, 169, "random"),
                    (4, 240, "random"), (3, 257, "random"), (2, 300, "random"),
                    (9, 10, "zeros"), (4, 150, "zeros"), (9, 10, "positive"),
                    (4, 150, "positive"), (8, ps.SMALL_PORTS, "random"),
                    (8, ps.SMALL_PORTS + 1, "random")]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,kind", _PS_KERNEL_CASES)
def test_port_stats_kernel_matches_plain(cuda, M, N, kind):
    """The plan's and every tiling bit for bit equal to the twin and to host
    NumPy, on an aligned tensor and on a view one double off the 16-byte
    grid (the scalar edges of the loads)."""
    d_h = _demands_of(M, N, kind)
    rho_h, tau_h = host_port_stats(d_h)
    aligned = torch.from_numpy(d_h).to(cuda)
    shifted = torch.empty(d_h.size + 1, dtype=torch.float64, device=cuda)[1:].view(d_h.shape)
    shifted.copy_(aligned)
    rho_p, tau_p = ps.port_stats_plain(aligned)
    assert rho_p.cpu().numpy().tobytes() == rho_h.tobytes()
    for d in (aligned, shifted):
        for p in [None] + ps.tilings(M, N):
            before = ps.LAUNCHES
            rho, tau = ps.port_stats(d, plan=p)
            torch.cuda.synchronize()
            assert ps.LAUNCHES == before + 1
            assert torch.equal(rho, rho_p) and torch.equal(tau, tau_p), p
            assert np.array_equal(tau.cpu().numpy(), tau_h)


@pytest.mark.cuda
def test_port_stats_kernel_refuses_past_its_limits(cuda):
    d = torch.zeros((1, ps.MAX_PORTS + 1, ps.MAX_PORTS + 1), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match=f"at most {ps.MAX_PORTS} ports"):
        ps.port_stats(d)
    d = torch.zeros((2, 600, 600), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ps.port_stats(d, plan=ps.tiling(2, 600, "stream", 32, 4))


@pytest.mark.parametrize("B,M,P", [(1, 10, 8), (3, 20, 24), (2, 33, 5), (2, 12, 129), (1, 9, 300)])
def test_lp_terms_batch_plain_matches_oracles(B, M, P):
    args = _lp_inputs(B, M, P, B * 1000 + M + P)
    got = lt.lp_terms_batch(*map(torch.from_numpy, args))
    jargs = tuple(map(jnp.asarray, args))
    tol = lt.rtol(M)
    for ref in (lp_terms_batch_ref(*jargs), lp_terms_batch_pallas(*jargs, interpret=True)):
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=tol, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_hard_completion_masked_max_on_mixed_bucket(seed):
    """Unmasked max over the zero-padded port width == the reference's
    -inf-masked max, on a bucket mixing port counts (and coflow counts)."""
    refs = [
        random_instance(num_coflows=m, num_ports=n, num_cores=2, seed=seed * 10 + i,
                        release_span=10.0 * (i % 2))
        for i, (m, n) in enumerate([(6, 2), (9, 5), (4, 3)])
    ]
    arrays = ref_lp.pack_lp_arrays(refs, pad_coflows=12, pad_ports=12)
    rng = np.random.default_rng(seed)
    Y = np.triu(rng.random(arrays["Y0"].shape), 1).astype(np.float32)
    names = ("p_rho", "p_tau", "releases", "inv_R", "delta_over_K", "coflow_mask", "port_mask")
    import jax

    want = jax.vmap(ref_lp._completion_from_Y_masked)(
        jnp.asarray(Y), *(jnp.asarray(arrays[k]) for k in names)
    )
    t = from_reference(arrays, "cpu")
    got = port_lp._completion_from_Y(torch.from_numpy(Y), *(t[k] for k in names))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=lt.rtol(12), atol=0)


def test_lp_terms_batch_validates():
    args = list(map(torch.from_numpy, _lp_inputs(2, 4, 3, 0)))
    with pytest.raises(ValueError, match="scales"):
        lt.lp_terms_batch(*args[:3], args[3][:1], args[4])
    with pytest.raises(TypeError, match="float32"):
        lt.lp_terms_batch(args[0].double(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,P", [(32, 104, 24), (3, 33, 5), (2, 7, 128), (4, 64, 300), (2, 33, 129)])
def test_lp_terms_batch_kernel_matches_plain(cuda, B, M, P):
    args = [torch.from_numpy(a).to(cuda) for a in _lp_inputs(B, M, P, M)]
    got = lt.lp_terms_batch(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, lt.lp_terms_batch_plain(*args)):
        assert bool((a - b).abs().le(lt.rtol(M) * b.abs()).all())


# --------------------------------------------------------------- lp_terms plan
# Shapes and SM counts the plan is swept over: the main path's, the whole
# trace's, and the chunk and port-tile edges.
_PLAN_SWEEP = [
    (B, M, P, sms)
    for B in (1, 3, 32)
    for M in (1, 31, 32, 33, 65, 100, 104, 128, 129, 526)
    for P in (1, 7, 8, 9, 20, 24, 64, 65, 129, 300)
    for sms in (1, 66, 132)
]
_SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory


@pytest.mark.parametrize("M", [1, 31, 32, 33, 65, 100, 104, 128, 129, 526])
def test_lp_terms_plan_covers_outputs_and_chunks(M):
    """Every (b, m, p) output in exactly one block, and within a block in
    exactly one thread of each chunk group; every q in exactly one chunk,
    added in order, each chunk inside its round's stage; threads and shared
    memory within the kernel's limits."""
    for B, _, P, sms in (c for c in _PLAN_SWEEP if c[1] == M):
        p = lt.plan(B, M, P, sms)
        nb, nm, np_ = p.grid
        assert nb == B
        # Blocks cut m and p into disjoint ranges that cover them.
        assert (nm - 1) * p.rows < M <= nm * p.rows
        assert (np_ - 1) * p.ports < P <= np_ * p.ports
        assert p.split == (np_ > 1) == (P > lt.WHOLE_PORTS)
        assert p.ports % 4 == 0 and p.rows % p.rows_per_thread == 0
        assert p.ports == (lt.SPLIT_PORTS if p.split else -(-P // 4) * 4)
        # A group's threads tile the block's rows x ports once.
        assert p.threads == p.groups * (p.rows // p.rows_per_thread) * (p.ports // 4)
        assert p.threads <= 512 and p.smem <= _SMEM_LIMIT
        # Chunk c of 32 q runs in group c % groups of round c // groups:
        # the rounds take every chunk, round 0 keeps every group busy, and
        # a round's q rows fit its stage (the whole extent in one round).
        chunks = -(-M // lt.CHUNK)
        assert 1 <= p.groups <= min(4, chunks)
        assert (p.rounds - 1) * p.groups < chunks <= p.rounds * p.groups
        assert p.stage_rows == (M if p.rounds == 1 else p.groups * lt.CHUNK)


@pytest.mark.parametrize("B,M,P,min_blocks", [
    (1, 526, 300, 132),  # the whole trace fills the card
    (1, 100, 20, 5),  # one paper instance: more than the old 4 blocks
    (32, 104, 24, 66),  # the paper bucket: one block per (member, 32 rows)
])
def test_lp_terms_plan_fills_the_card(B, M, P, min_blocks):
    p = lt.plan(B, M, P, 132)
    assert p.grid[0] * p.grid[1] * p.grid[2] >= min_blocks
    assert p.smem <= _SMEM_LIMIT
    # The main path's shapes keep every port in one block: one launch, no fill.
    assert p.split == (P > lt.WHOLE_PORTS)


# -------------------------------------------------------------------- lp_terms
@pytest.mark.cuda
@pytest.mark.parametrize("M,P", [(100, 20), (37, 6), (526, 300), (1, 1), (33, 129)])
def test_lp_terms_kernel_matches_plain_and_batch(cuda, M, P):
    """The single-instance kernel within rtol(M) of its twin, and
    bit-identical to the batched kernel on a one-member batch (the two
    share one device function)."""
    X, rho, tau, inv_R, dok = (torch.from_numpy(a).to(cuda) for a in _lp_inputs(1, M, P, M))
    args = (X[0], rho[0], tau[0], float(inv_R[0]), float(dok[0]))
    before = (lt.SINGLE_LAUNCHES, lt.LAUNCHES)
    got = lt.lp_terms(*args)
    torch.cuda.synchronize()
    assert (lt.SINGLE_LAUNCHES, lt.LAUNCHES) == (before[0] + 1, before[1])
    for a, b in zip(got, lt.lp_terms_plain(*args)):
        assert bool((a - b).abs().le(lt.rtol(M) * b.abs()).all())
    batch = lt.lp_terms_batch(X, rho, tau, inv_R, dok)
    for a, b in zip(got, batch):
        assert torch.equal(a, b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 7, 8, 9, 24, 129, 300])
@pytest.mark.parametrize("M", [1, 31, 32, 33, 65, 526])
def test_lp_terms_kernels_at_chunk_and_tile_edges(cuda, M, P):
    """Both kernels within rtol(M) of their twins across chunk, row-tile
    and port-tile edges (split p past 64 ports included); the single
    kernel bit-identical to the batch's member; a call repeats its bits."""
    X, rho, tau, inv_R, dok = (torch.from_numpy(a).to(cuda) for a in _lp_inputs(3, M, P, M + P))
    got = lt.lp_terms_batch(X, rho, tau, inv_R, dok)
    again = lt.lp_terms_batch(X, rho, tau, inv_R, dok)
    torch.cuda.synchronize()
    for a, b, c in zip(got, lt.lp_terms_batch_plain(X, rho, tau, inv_R, dok), again):
        assert bool((a - b).abs().le(lt.rtol(M) * b.abs()).all())
        assert torch.equal(a, c)
    args = (X[1], rho[1], tau[1], float(inv_R[1]), float(dok[1]))
    single = lt.lp_terms(*args)
    for a, b, c in zip(single, lt.lp_terms_plain(*args), got):
        assert bool((a - b).abs().le(lt.rtol(M) * b.abs()).all())
        assert torch.equal(a, c[1])


@pytest.mark.cuda
def test_lp_terms_kernel_refuses_tiles_it_cannot_run(cuda):
    """A tiling with more chunk groups than chunks, a port tile that
    misses ports, or rows the kernel has no instance for is refused before
    launch."""
    import dataclasses

    X, rho, tau = (torch.from_numpy(a).to(cuda) for a in _lp_inputs(1, 40, 24, 0)[:3])
    p = lt.plan(1, 40, 24, 132)
    for bad in (dict(groups=3), dict(ports=16), dict(rows=12)):
        with pytest.raises(RuntimeError, match="lp_terms failed to launch"):
            lt.lp_terms(X[0], rho[0], tau[0], 1.0, 1.0, tiling=dataclasses.replace(p, **bad))


@pytest.mark.cuda
def test_lp_terms_plan_smem_is_the_sources(cuda):
    """`Plan.smem` is the shared memory the C entry derives from the same
    tiles, across the plan sweep."""
    import ctypes

    from repro_torch.kernels.common import launch

    for B, M, P, sms in _PLAN_SWEEP:
        p = lt.plan(B, M, P, sms)
        got = ctypes.c_longlong(0)
        launch("lp_terms_smem", M, p.rows, p.ports, p.groups, ctypes.byref(got),
               device=torch.device("cuda"))
        assert got.value == p.smem, (B, M, P, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("M,P", [(31, 9), (65, 24), (104, 24), (129, 20), (526, 300)])
def test_lp_terms_bits_depend_on_m_alone(cuda, M, P):
    """Every tiling the kernel takes -- rows a block, rows a thread, chunk
    groups -- gives the same bits, in a batch of 3 and for one instance:
    the association of each sum depends on M alone."""
    X, rho, tau, inv_R, dok = (torch.from_numpy(a).to(cuda) for a in _lp_inputs(3, M, P, 7))
    want = lt.lp_terms_batch(X, rho, tau, inv_R, dok)
    seen = set()
    for rows in (32, 16, 8):
        for tm in (2, 1):
            for groups in (1, 2, 3, 4):
                p = lt.tiles(3, M, P, rows, tm, groups)
                if p.threads > 512 or (rows, tm, p.groups) in seen:
                    continue
                seen.add((rows, tm, p.groups))
                got = lt.lp_terms_batch(X, rho, tau, inv_R, dok, tiling=p)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), p
                one = lt.lp_terms(X[2], rho[2], tau[2], float(inv_R[2]), float(dok[2]),
                                  tiling=p)
                assert torch.equal(one[0], want[0][2]) and torch.equal(one[1], want[1][2]), p
    assert len({groups for _, _, groups in seen}) == min(4, -(-M // lt.CHUNK))


@pytest.mark.cuda
@pytest.mark.parametrize("M,P", [(104, 24), (64, 300)])
def test_lp_terms_batch_members_bit_identical_to_single(cuda, M, P):
    """Member b of a B = 32 batch equals `lp_terms` on member b alone, bit
    for bit (the plans differ; the association depends on M alone)."""
    X, rho, tau, inv_R, dok = (torch.from_numpy(a).to(cuda) for a in _lp_inputs(32, M, P, 5))
    assert lt.plan(32, M, P, 132) != lt.plan(1, M, P, 132)
    load, rec = lt.lp_terms_batch(X, rho, tau, inv_R, dok)
    for b in range(32):
        one = lt.lp_terms(X[b], rho[b], tau[b], float(inv_R[b]), float(dok[b]))
        assert torch.equal(one[0], load[b]) and torch.equal(one[1], rec[b])


# ------------------------------------------------------------- flash_attention
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Skv,D,causal,window,off",
    [
        (4, 4, 1, 600, 617, 256, True, 512, 0),   # gemma3 prefill, local layer
        (4, 4, 1, 1, 617, 256, True, None, 600),  # gemma3 decode, global layer
        (2, 4, 2, 256, 256, 64, True, None, 0),
        (1, 2, 2, 256, 256, 64, True, 100, 0),
        (1, 2, 2, 128, 128, 128, False, None, 0),
        (1, 3, 1, 64, 320, 32, True, None, 256),
        (2, 4, 2, 40, 57, 16, True, 16, 0),
        # Route boundaries: rows per (b, kv head) below, at and above the
        # tensor-core tile of 64, and at the split route's 16.
        (1, 1, 1, 63, 70, 64, True, None, 0),
        (1, 1, 1, 64, 70, 64, True, None, 0),
        (1, 1, 1, 65, 70, 64, True, None, 0),
        (1, 4, 1, 4, 300, 128, True, None, 200),  # 16 rows, split
        (1, 1, 1, 17, 300, 128, True, None, 200),  # 17 rows, tiled
        (1, 4, 1, 5, 50, 32, True, None, 45),  # 20 rows over 4 heads, tiled
        # Decode with group 1, 4 and 8.
        (2, 1, 1, 1, 300, 128, True, 40, 299),
        (4, 4, 1, 1, 617, 256, True, 512, 600),
        (2, 8, 1, 1, 300, 128, True, None, 299),
        # A window that leaves whole runs without a live key for some rows.
        (1, 1, 1, 16, 616, 64, True, 64, 600),
        # Skv a multiple of no tile; multi-row queries at q_offset > 0.
        (2, 4, 2, 100, 203, 16, True, 17, 40),
        (2, 4, 2, 100, 203, 256, False, None, 7),
        # Fully masked rows: zeros (some rows; every row).
        (1, 2, 1, 8, 64, 32, False, 2, 60),
        (1, 2, 1, 1, 64, 32, True, 0, 10),
        (1, 1, 1, 80, 90, 128, False, 3, 60),
        # gemma3 training: batch 4 x 1024 tokens.
        (4, 4, 1, 1024, 1024, 256, True, None, 0),
        # Cross-attention, non-causal over the encoder's keys: llama-3.2-
        # vision's prefill and decode (1601 image tokens), musicgen's (64).
        (4, 32, 32, 600, 1601, 128, False, None, 0),
        (4, 32, 32, 1, 1601, 128, False, None, 0),
        (4, 24, 24, 600, 64, 64, False, None, 0),
        (4, 24, 24, 1, 64, 64, False, None, 0),
    ],
)
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Hq, Hkv, Sq, Skv, D, causal, window, off):
    rng = np.random.default_rng(Sq * 1000 + Skv + D)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
        for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal, window, off)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1 and got.dtype == dtype
    want = fa.flash_attention_plain(q, k, v, causal, window, off).to(torch.float32)
    # A row no key is visible to: the kernels write zeros, the twin the mean
    # of v (module doc).
    qi = off + np.arange(Sq)[:, None]
    kj = np.arange(Skv)[None, :]
    seen = np.ones((Sq, Skv), bool)
    if causal:
        seen &= qi >= kj
    if window is not None:
        seen &= qi - kj < window
    dead = torch.from_numpy(~seen.any(axis=1)).to(cuda)
    assert bool((got[:, :, dead] == 0).all())
    want[:, :, dead] = 0
    err = (got.to(torch.float32) - want).abs()
    if dtype == torch.float32:
        assert bool((err <= 2e-5).all())
    else:
        assert bool((err <= 2**-7 * want.abs() + 1e-5).all())
    # The model's (B, S, H, D) tensors, viewed as (B, H, S, D): same bits;
    # and the same inputs again: same bits (the split route merges its
    # runs in a fixed order).
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(fa.flash_attention(*views, causal, window, off), got)
    assert torch.equal(fa.flash_attention(q, k, v, causal, window, off), got)
