"""The port's `event_resolve` against the JAX package's flow-space round.

* The twin against `event_resolve_ref` and the interpret-mode Pallas
  kernel `event_resolve_pallas` (reserving; inputs f32-exact, since both
  compare in f32 and the port in f64), at the reference's own cases plus
  one with repeated (src, dst) pairs.
* The twin against `repro.core.circuit.resolve_event` member by member on
  f64 inputs whose structure lies below f32's resolution, both
  disciplines; its first claimers against `np.minimum.at`.
* Greedy equals the reference's reserving round with ``pending := idle``.
* `plan`: the route by shape, every flow in exactly one block (CPU).
* The kernel against the twin on the card on every route (marked
  ``cuda``; skips here).

Tolerance everywhere: none (boolean masks and integer ids).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.circuit import resolve_event
from repro.kernels.event_resolve.kernel import event_resolve_pallas
from repro.kernels.event_resolve.ref import event_resolve_ref
from repro_torch.kernels import event_resolve as er

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

DISCIPLINES = ["reserving", "greedy"]
# The reference's cases (tests/test_kernels.py), then repeated pairs:
# every flow on one of 3 (src, dst) pairs of 4 ports.
CASES = [(1, 1, 1, None), (3, 17, 5, None), (8, 130, 9, None), (4, 64, 4, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _state(seed, G, F, N, pairs=None, f32=True):
    """A random round's operands as NumPy arrays: f32-exact values (for
    the f32 reference) or f64 values with sub-f32 structure."""
    rng = np.random.default_rng(seed)
    if pairs is None:
        src = rng.integers(0, N, (G, F))
        dst = rng.integers(0, N, (G, F))
    else:
        table = rng.integers(0, N, (pairs, 2))
        pick = rng.integers(0, pairs, (G, F))
        src, dst = table[pick, 0], table[pick, 1]

    def times(shape):
        x = rng.uniform(0, 10, shape)
        if f32:
            return x.astype(np.float32).astype(np.float64)
        return x * (1 + 1e-12)

    return dict(
        src=src.astype(np.int32), dst=dst.astype(np.int32), rel=times((G, F)),
        free_in=times((G, N)), free_out=times((G, N)),
        pending=rng.random((G, F)) < 0.7, t=times(G),
    )


def _port(s, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in s.items()}


def _reference(s):
    """`event_resolve_ref` and interpret-mode Pallas on the f32 values."""
    j = dict(
        src=jnp.asarray(s["src"]), dst=jnp.asarray(s["dst"]),
        rel=jnp.asarray(s["rel"], jnp.float32),
        free_in=jnp.asarray(s["free_in"], jnp.float32),
        free_out=jnp.asarray(s["free_out"], jnp.float32),
        pending=jnp.asarray(s["pending"]), t=jnp.asarray(s["t"], jnp.float32),
    )
    ref = np.asarray(event_resolve_ref(**j))
    pallas = np.asarray(event_resolve_pallas(
        j["src"], j["dst"], j["rel"], j["pending"].astype(jnp.float32),
        j["free_in"], j["free_out"], j["t"], interpret=True,
    )) > 0.5
    return ref, pallas


def _idle(s):
    t = s["t"][:, None]
    waiting = s["pending"] & (s["rel"] <= t)
    return (
        waiting
        & (np.take_along_axis(s["free_in"], s["src"], 1) <= t)
        & (np.take_along_axis(s["free_out"], s["dst"], 1) <= t)
    )


@pytest.mark.parametrize("G,F,N,pairs", CASES)
def test_plain_matches_reference_and_pallas(G, F, N, pairs):
    s = _state(G * 1000 + F, G, F, N, pairs)
    start, first_in, first_out, blocked = er.event_resolve(**_port(s))
    assert start.dtype == blocked.dtype == torch.bool
    assert first_in.dtype == first_out.dtype == torch.int32
    ref, pallas = _reference(s)
    assert np.array_equal(start.numpy(), ref)
    assert np.array_equal(start.numpy(), pallas)


@pytest.mark.parametrize("G,F,N,pairs", CASES)
def test_greedy_is_reserving_with_pending_idle(G, F, N, pairs):
    s = _state(G * 1000 + F + 1, G, F, N, pairs)
    start = er.event_resolve(**_port(s), discipline="greedy")[0].numpy()
    ref, pallas = _reference({**s, "pending": _idle(s)})
    assert np.array_equal(start, ref)
    assert np.array_equal(start, pallas)


@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("seed", range(3))
def test_plain_matches_resolve_event_in_f64(seed, discipline):
    """Member by member: the start mask of `resolve_event`, first
    claimers of `np.minimum.at`, and ``blocked`` = some idle flow did not
    start."""
    rng = np.random.default_rng(seed)
    G, F, N = 5, int(rng.integers(1, 60)), int(rng.integers(1, 9))
    s = _state(seed, G, F, N, pairs=None if seed else 2, f32=False)
    start, first_in, first_out, blocked = (
        x.numpy() for x in er.event_resolve(**_port(s), discipline=discipline)
    )
    idle = _idle(s)
    for g in range(G):
        waiting = s["pending"][g] & (s["rel"][g] <= s["t"][g])
        src, dst = s["src"][g].astype(np.int64), s["dst"][g].astype(np.int64)
        want = resolve_event(src, dst, s["free_in"][g], s["free_out"][g], waiting,
                             float(s["t"][g]), discipline=discipline)
        assert np.array_equal(start[g], want), g
        claim = waiting if discipline == "reserving" else idle[g]
        ids = np.where(claim, np.arange(F), F)
        for ports, got in ((src, first_in[g]), (dst, first_out[g])):
            first = np.full(N, F)
            np.minimum.at(first, ports, ids)
            assert np.array_equal(got, first), g
        assert blocked[g] == (idle[g] & ~want).any(), g


# discipline: start mask, first claimers per ingress and egress, blocked.
_HOLD = {
    "reserving": ([True, False, False], [0, 3, 1, 3], [2, 0, 3, 1], True),
    "greedy": ([True, False, True], [0, 3, 2, 3], [2, 0, 3, 3], False),
}


@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_reserving_holds_ports_greedy_does_not(discipline):
    """At t = 0 flows 0 (0->1) and 2 (2->0) are idle; flow 1 (2->3) waits
    but egress 3 is busy.  Under reserving flow 1 holds ingress 2 ahead of
    flow 2; under greedy only idle flows claim, so flow 2 starts."""
    s = dict(
        src=np.array([[0, 2, 2]], np.int32), dst=np.array([[1, 3, 0]], np.int32),
        rel=np.zeros((1, 3)), free_in=np.zeros((1, 4)),
        free_out=np.array([[0.0, 0.0, 0.0, 5.0]]), pending=np.ones((1, 3), bool),
        t=np.zeros(1),
    )
    got = er.event_resolve(**_port(s), discipline=discipline)
    start, first_in, first_out, blocked = _HOLD[discipline]
    assert got[0].tolist() == [start]
    assert got[1].tolist() == [first_in]
    assert got[2].tolist() == [first_out]
    assert got[3].tolist() == [blocked]


def test_cpu_call_does_not_count():
    s = _port(_state(0, 2, 9, 3))
    before = er.LAUNCHES
    er.event_resolve(**s)
    er.event_resolve(**s, discipline="greedy")
    assert er.LAUNCHES == before


# Each operand broken in turn: (operand, replacement, error, message).
_BAD = [
    ("src", lambda s: s["src"].long(), TypeError, "'src' must be torch.int32"),
    ("src", lambda s: s["src"][0], ValueError, "'src' must be \\(G, F\\)"),
    ("dst", lambda s: s["dst"][:, :-1], ValueError, "'dst' has shape"),
    ("rel", lambda s: s["rel"].float(), TypeError, "'rel' must be torch.float64"),
    ("free_in", lambda s: s["free_in"][:1], ValueError, "'free_in' must be \\(G, N\\)"),
    ("free_out", lambda s: s["free_out"][:, :-1], ValueError, "'free_out' has shape"),
    ("pending", lambda s: s["pending"].int(), TypeError, "'pending' must be torch.bool"),
    ("t", lambda s: s["t"][:1], ValueError, "'t' has shape"),
    ("t", lambda s: float(s["t"][0]), TypeError, "'t' must be a tensor"),
]


@pytest.mark.parametrize("name,bad,err,msg", _BAD, ids=[f"{b[0]}-{i}" for i, b in enumerate(_BAD)])
def test_validation_names_the_operand(name, bad, err, msg):
    s = _port(_state(1, 2, 9, 3))
    with pytest.raises(err, match=msg):
        er.event_resolve(**{**s, name: bad(s)})


def test_unknown_discipline_raises():
    with pytest.raises(ValueError, match="unknown discipline"):
        er.event_resolve(**_port(_state(1, 2, 9, 3)), discipline="fifo")


# (G, F, N): the main path, fig5, the whole trace, and either side of the
# route switch (`BLOCK_FLOWS`), of the 4-flow vector loads (F % 4) and of a
# cluster block's range; F = 0; one member.
_PLAN_CASES = [(96, 336, 12), (8, 1520, 32), (8, 266_272, 152), (1, 266_260, 152),
               (2, 0, 4), (1, 1, 1), (1, er.BLOCK_FLOWS, 8), (1, er.BLOCK_FLOWS + 1, 8),
               (2, er.BLOCK_FLOWS + 4, 8), (96, 92_928, 152), (3, 2_000_000, 152),
               (1, 1_900_000, 4)]


def _every_plan(G, F, N):
    """Every tiling, each also with one flow a lane where it takes 4."""
    plans = er.tilings(G, F, N)
    return plans + [er.tiling(G, F, N, p.cluster, vector=1) for p in plans if p.vector == 4]


@pytest.mark.parametrize("G,F,N", _PLAN_CASES)
def test_plan_routes_and_covers_every_flow(G, F, N):
    """The block route up to `BLOCK_FLOWS`, the cluster route past it;
    every flow of a member in exactly one block, the grid a multiple of the
    cluster size, and threads and shared memory within the kernel's limits;
    so for every other tiling the sweep runs.  The plan's cluster blocks
    all hold flows (a forced cluster at a few flows may leave blocks
    empty, which the cuda tests run)."""
    for sms in (1, 66, 132):
        p = er.plan(G, F, N, sms)
        assert p.route == ("block" if F <= er.BLOCK_FLOWS else "cluster")
        for q in [p] + _every_plan(G, F, N):
            assert q.grid == G * q.cluster and q.grid % q.cluster == 0
            assert q.threads % 32 == 0 and 32 <= q.threads <= 1024
            assert q.vector == 1 or (q.vector == 4 and F % 4 == 0)
            # The one 64-bit argument the C entry unpacks.
            assert (q.word & 0xFFFFFFFF, q.word >> 32 & 0x7FF, q.word >> 43 & 0xF,
                    q.word >> 47) == (q.span, q.threads, q.cluster, q.vector)
            if q.route == "block":
                assert q.cluster == 1 and q.span == F
                assert q.smem == 4 * (2 * N + -(-F // 32)) <= 232_448
                continue
            assert 2 <= q.cluster <= er.MAX_CLUSTER and q.span % er.SPAN_QUANTUM == 0
            assert q.smem == 4 * (4 * N + q.span // 32) <= 48 * 1024
            flows = np.zeros(F, dtype=int)
            for r in range(q.cluster):
                block = slice(r * q.span, min(F, (r + 1) * q.span))
                assert block.start < block.stop or q is not p
                flows[block] += 1
            assert (flows == 1).all()


@pytest.mark.cuda
def test_plan_dims_are_the_sources(cuda):
    """`Plan.grid`, ``threads`` and ``smem`` are what the C entry unpacks
    from the plan's ``word``, for every plan and tiling of the plan cases."""
    import ctypes

    from repro_torch.kernels.common import launch

    out = (ctypes.c_longlong * 3)()
    for G, F, N in _PLAN_CASES:
        plans = [er.plan(G, F, N, sms) for sms in (1, 66, 132)] + _every_plan(G, F, N)
        for q in plans:
            launch("event_resolve_dims", G, F, N, q.word, out, device=torch.device("cuda"))
            assert tuple(out) == (q.grid, q.threads, q.smem), (G, F, N, q)


# (G, F, N, pairs) on the card: the reference's cases, the main path's
# bucket, fig5, the whole trace, either side of the route switch and of the
# vector loads, F = 0, and a range that ends mid-block.
_KERNEL_CASES = CASES + [
    (96, 320, 12, None), (3, 1400, 32, None), (1, 266_272, 152, None), (2, 0, 4, None),
    (1, er.BLOCK_FLOWS, 8, None), (2, er.BLOCK_FLOWS + 4, 8, None),
    (2, er.BLOCK_FLOWS + 1, 8, 3), (1, 266_260, 152, None), (3, 9_001, 5, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("G,F,N,pairs", _KERNEL_CASES)
def test_kernel_matches_plain(cuda, G, F, N, pairs, discipline):
    """Every tiling (`tilings`, with 1 and 4 flows a lane) and the plan's
    equal to the twin."""
    s = _port(_state(G + F + N, G, F, N, pairs, f32=False), cuda)
    want = er.event_resolve_plain(**s, discipline=discipline)
    for p in [None] + _every_plan(G, F, N):
        before = er.LAUNCHES
        got = er.event_resolve(**s, discipline=discipline, plan=p)
        torch.cuda.synchronize()
        assert er.LAUNCHES == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), p


@pytest.mark.cuda
@pytest.mark.parametrize("discipline", DISCIPLINES)
@pytest.mark.parametrize("G,F,N", [(8, 266_272, 152), (8, 1520, 32), (96, 336, 12)])
def test_kernel_one_live_member_matches_plain(cuda, G, F, N, discipline):
    """One live member among members that pend nothing (the calendar's
    padding and finished members), every tiling."""
    st = _state(F, G, F, N, f32=False)
    st["pending"][np.arange(G) != G // 2] = False
    s = _port(st, cuda)
    want = er.event_resolve_plain(**s, discipline=discipline)
    for p in [None] + _every_plan(G, F, N):
        got = er.event_resolve(**s, discipline=discipline, plan=p)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), p


@pytest.mark.cuda
def test_kernel_on_unaligned_views(cuda):
    """Operands one element past an aligned start take the 1-flow loads."""
    st = _state(5, 2, 20_000, 16, f32=False)
    s = {}
    for k, v in _port(st, cuda).items():
        s[k] = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)[1:].view(v.shape)
        s[k].copy_(v)
    want = er.event_resolve_plain(**s, discipline="greedy")
    for p in [None] + er.tilings(2, 20_000, 16):
        got = er.event_resolve(**s, discipline="greedy", plan=p)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), p


@pytest.mark.cuda
def test_kernel_refuses_past_its_shared_memory(cuda):
    """Past the block route's 227 KB and every cluster's 48 KB: at 4 ports,
    7 million flows need 8 blocks of 109 KB or one of 875 KB."""
    s = _port(_state(0, 1, 7_000_000, 4), cuda)
    with pytest.raises(ValueError, match="shared memory"):
        er.event_resolve(**s)
