"""`repro_torch.kernels.mlstm_chunk` on the host: the plain twin (which the
wrapper takes for CPU tensors) against the reference's naive recurrence
``mlstm_ref``, its interpret-mode Pallas kernel ``mlstm_chunk_pallas`` and
the model's chunkwise form ``_mlstm_chunk_scan``; `plan`'s routes on the
host; every route of the kernel against the twin on the card (marked
``cuda``; they skip without one).

Tolerances, the reference's own for its kernel (`tests/test_mlstm_kernel.py`):
  * 2e-4 (rtol and atol) in f32 against ``mlstm_ref``, the Pallas kernel and
    ``_mlstm_chunk_scan``, with a zero or a carried initial state, and
    between chunk lengths (summation order only);
  * bf16 inputs: 5e-2 against the f32 oracle on the same (rounded) values;
  * kernel against twin on the card: 2e-4 in f32 for h and the state; in
    bf16 the state within 2e-4 (both widen the same bf16 values to f32) and
    h within one bf16 rounding of the twin's (2**-7 of the value) plus the
    f32 tolerance, since both round an f32 result once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.mlstm_chunk import mlstm_ref
from repro.kernels.mlstm_chunk.kernel import mlstm_chunk_pallas
from repro.models.xlstm import _mlstm_chunk_scan
from repro_torch.kernels import mlstm_chunk as mc

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

# The reference's cases (`tests/test_mlstm_kernel.py`): BH, S, Dh, chunk.
REF_CASES = [(2, 64, 32, 16), (1, 128, 64, 32), (3, 96, 16, 32), (2, 256, 128, 128)]
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(BH, S, D, seed=0):
    """The reference test's inputs (`make_inputs`), as numpy f32."""
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((BH, S, D)).astype(np.float32),
        (rng.standard_normal((BH, S, D)) / np.sqrt(D)).astype(np.float32),
        rng.standard_normal((BH, S, D)).astype(np.float32),
        np.log(rng.uniform(0.8, 0.999, (BH, S))).astype(np.float32),
        rng.uniform(-2.0, 1.0, (BH, S)).astype(np.float32),
    )


def _state(BH, D, seed):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((BH, D, D)) * 0.1).astype(np.float32),
        rng.standard_normal((BH, D)).astype(np.float32),
    )


def _t(arrays, dtype=torch.float32, device="cpu"):
    """Tensors of the numpy inputs: q, k, v in ``dtype``, gates in f32."""
    return [
        torch.from_numpy(a).to(device, dtype if i < 3 else torch.float32)
        for i, a in enumerate(arrays)
    ]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------------ the twin
@pytest.mark.parametrize("BH,S,D,chunk", REF_CASES)
def test_twin_matches_reference_and_pallas(BH, S, D, chunk):
    args = _inputs(BH, S, D, seed=BH * S)
    h, (S_fin, n_fin) = mc.mlstm_chunk(*_t(args), chunk=chunk)
    assert h.dtype == torch.float32 and h.shape == (BH, S, D)
    h_r, (S_r, n_r) = mlstm_ref(*map(jnp.asarray, args))
    h_p, (S_p, n_p) = mlstm_chunk_pallas(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    for got, ref, pallas in ((h, h_r, h_p), (S_fin, S_r, S_p), (n_fin, n_r, n_p)):
        _close(got.numpy(), ref)
        _close(got.numpy(), pallas)


@pytest.mark.parametrize("BH,S,D,chunk", REF_CASES)
def test_twin_carries_state_like_the_reference(BH, S, D, chunk):
    """A nonzero initial state: against ``mlstm_ref(state=)`` and the
    reference model's ``_mlstm_chunk_scan`` (H folded into the batch)."""
    args = _inputs(BH, S, D, seed=S + D)
    state = _state(BH, D, seed=D)
    h, (S_fin, n_fin) = mc.mlstm_chunk(
        *_t(args), state=tuple(map(torch.from_numpy, state)), chunk=chunk
    )
    h_r, (S_r, n_r) = mlstm_ref(*map(jnp.asarray, args), state=tuple(map(jnp.asarray, state)))
    NC = S // chunk
    rs = lambda a: jnp.asarray(a).reshape(BH, NC, chunk, 1, *a.shape[2:])  # noqa: E731
    out, (S_s, n_s) = _mlstm_chunk_scan(
        *(rs(a) for a in args),
        (jnp.asarray(state[0])[:, None], jnp.asarray(state[1])[:, None]),
    )
    for got, ref, scan in ((h, h_r, out[:, :, 0]), (S_fin, S_r, S_s[:, 0]), (n_fin, n_r, n_s[:, 0])):
        _close(got.numpy(), ref)
        _close(got.numpy(), scan)


def test_twin_split_equals_one_call():
    """Two calls with the state carried between them equal one call: the
    serving path's prefill then decode steps."""
    args = _t(_inputs(2, 48, 32, seed=5))
    h, state = mc.mlstm_chunk(*args, chunk=16)
    first = [a[:, :32] for a in args]
    rest = [a[:, 32:] for a in args]
    h1, mid = mc.mlstm_chunk(*first, chunk=16)
    h2, end = mc.mlstm_chunk(*rest, state=mid, chunk=16)
    _close(torch.cat([h1, h2], dim=1).numpy(), h.numpy())
    for got, want in zip(end, state):
        _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("chunks", [(16, 64), (8, 128), (1, 32)])
def test_twin_chunk_invariance(chunks):
    args = _t(_inputs(1, 128, 32, seed=11))
    state = tuple(map(torch.from_numpy, _state(1, 32, seed=12)))
    (h1, (S1, n1)), (h2, (S2, n2)) = (mc.mlstm_chunk(*args, state=state, chunk=c) for c in chunks)
    for a, b in ((h1, h2), (S1, S2), (n1, n2)):
        _close(a.numpy(), b.numpy())


def test_twin_bf16_inputs():
    args = _inputs(1, 64, 32, seed=7)
    q, k, v, lf, li = _t(args, torch.bfloat16)
    h, (S_fin, _) = mc.mlstm_chunk(q, k, v, lf, li, chunk=16)
    assert h.dtype == torch.bfloat16 and S_fin.dtype == torch.float32
    h_r, _ = mlstm_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), lf.numpy(), li.numpy())
    _close(h.float().numpy(), h_r, rtol=5e-2, atol=5e-2)


def test_twin_selects_masked_exponentials():
    """Masked entries (s > t) with e^{F_t - F_s} overflowing f32 stay exact
    zeros: selected, never multiplied by a 0/1 mask (no inf * 0 = NaN)."""
    q, k, v, lf, li = _t(_inputs(1, 16, 16, seed=3))
    lf = torch.full_like(lf, -20.0)  # F_t - F_s = 20 (s - t): e^300 at the corner
    h, (S_fin, n_fin) = mc.mlstm_chunk(q, k, v, lf, li, chunk=16)
    assert torch.isfinite(h).all() and torch.isfinite(S_fin).all() and torch.isfinite(n_fin).all()


# ---------------------------------------------------------------- validation
def test_validation_names_the_operand():
    q, k, v, lf, li = _t(_inputs(2, 32, 16))
    S0, n0 = map(torch.from_numpy, _state(2, 16, seed=1))
    bad = [
        (dict(q=q[0]), ValueError, "q must be"),
        (dict(k=k[:, :16]), ValueError, "k must have q's shape"),
        (dict(v=v.double()), TypeError, "v is torch.float64"),
        (dict(q=q.half(), k=k.half(), v=v.half()), TypeError, "q must be float32 or bfloat16"),
        (dict(log_f=lf[:, :8]), ValueError, "log_f must be"),
        (dict(log_i=li.to(torch.bfloat16)), TypeError, "log_i must be float32"),
        (dict(state=(S0[:, :8], n0)), ValueError, "S0 must be"),
        (dict(state=(S0, n0.double())), TypeError, "n0 must be float32"),
        (dict(chunk=12), ValueError, "not a multiple of chunk=12"),
    ]
    base = dict(q=q, k=k, v=v, log_f=lf, log_i=li, state=None, chunk=16)
    for over, exc, msg in bad:
        with pytest.raises(exc, match=msg):
            mc.mlstm_chunk(**{**base, **over})
    wide = _t(_inputs(1, 8, 48))
    with pytest.raises(ValueError, match="head dim Dh=48"):
        mc.mlstm_chunk(*wide)


# ------------------------------------------------------------------- routes
@pytest.mark.parametrize("dtype,BH,S,Dh,C,route", [
    (torch.bfloat16, 16, 768, 512, 256, "mma"),   # xLSTM prefill
    (torch.bfloat16, 16, 640, 512, 128, "mma"),   # chunks of 128 (smoke phase 7)
    (torch.bfloat16, 1, 128, 64, 32, "mma"),      # a chunk below 64
    (torch.bfloat16, 3, 96, 128, 48, "mma"),
    (torch.bfloat16, 16, 1, 512, 1, "stream"),    # xLSTM decode
    (torch.float32, 16, 1, 512, 1, "stream"),
    (torch.float32, 2, 64, 32, 1, "stream"),      # chunks of one over S positions
    (torch.bfloat16, 2, 40, 16, 1, "stream"),
    (torch.float32, 16, 768, 512, 256, "simt"),   # f32 prefill
    (torch.float32, 2, 256, 128, 128, "simt"),
    (torch.bfloat16, 2, 64, 32, 16, "simt"),      # Dh the mma route does not take
    (torch.bfloat16, 3, 96, 16, 32, "simt"),
])
def test_plan_picks_the_route(dtype, BH, S, Dh, C, route):
    assert mc.plan(dtype, BH, S, Dh, C) == route


def test_scratch_holds_each_chunks_split_state_and_normalizer():
    # (S / C) chunks x BH x (hi and lo bf16 planes of Dh x Dh, n_c in f32).
    assert mc.scratch_bytes(16, 768, 512, 256) == 3 * 16 * (512 * 512 * 2 * 2 + 512 * 4)


def test_cpu_call_leaves_launches_unchanged():
    before = mc.LAUNCHES
    mc.mlstm_chunk(*_t(_inputs(1, 16, 16)), chunk=8)
    assert mc.LAUNCHES == before


# ---------------------------------------------------------- kernel on a card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's products in f32
    return torch.device("cuda")


@pytest.mark.cuda
def test_main_path_shapes_fit_one_block(cuda):
    """Each route's main-path shapes fit a block's shared memory on the
    card: prefill (C = 256, and 128) and decode (C = 1) at Dh = 512, the
    reference's widest case (Dh = 128, C = 128) on the f32 route.  A chunk
    that does not fit is refused, naming the shared memory."""
    dev = torch.cuda.current_device()
    for route, Dh, C in (("mma", 512, 256), ("mma", 512, 128), ("stream", 512, 1),
                         ("simt", 512, 256), ("simt", 128, 128)):
        need, limit = mc.block_smem(dev, route, Dh, C)
        assert 0 < need <= limit, (route, Dh, C, need, limit)
    big = _t(_inputs(1, 4096, 512), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mc.mlstm_chunk(*big, chunk=4096)


@pytest.mark.cuda
@pytest.mark.parametrize("route,Dh,C,need", [
    # The output kernel: q's 64 rows, two ring stages of 64 x 128 bf16, F
    # and log_i of the chunk, n_c (the scan kernel takes less): two blocks
    # share an SM's 228 KB.
    ("mma", 512, 256, 2 * 64 * 512 + 2 * 2 * 64 * 128 + 4 * (2 * 256 + 512 + 4)),
    ("mma", 512, 128, 2 * 64 * 512 + 2 * 2 * 64 * 128 + 4 * (2 * 128 + 512 + 4)),
    # Dh = 64: the scan's ring of two (k, v) tile pairs is the larger.
    ("mma", 64, 32, 4 * 64 * 64 * 2 + 4 * (2 * 64 + 4)),
    ("stream", 512, 1, 4 * 8 * 18),  # per warp: 16 column sums, q . n, q . k
    ("simt", 512, 256, 4 * (512 * 64 + 512 + 2 * 16 * 516 + 16 * 64 + 16 * 16 + 16 + 3 * 256)),
    ("mma", 32, 16, 0),      # routes report 0 where they do not take the shape
    ("stream", 512, 256, 0),
])
def test_shared_memory_report_per_route(cuda, route, Dh, C, need):
    got, limit = mc.block_smem(torch.cuda.current_device(), route, Dh, C)
    assert got == need
    if route == "mma" and Dh == 512:
        assert 2 * (got + 1024) <= 228 * 1024  # two blocks an SM (1 KB reserved each)


def _pad_like_the_model(args, C):
    """Zero q/k/v, log_f = 0 and log_i = -30 after the last row, up to a
    multiple of C (`models/xlstm.py:mlstm_apply`)."""
    q, k, v, lf, li = args
    pad = -q.shape[1] % C
    F = torch.nn.functional.pad
    return [F(t, (0, 0, 0, pad)) for t in (q, k, v)] + [F(lf, (0, pad)), F(li, (0, pad), value=-30.0)]


def _matches_plain(args, state, chunk, dtype):
    route = mc.plan(dtype, *args[0].shape[:3], min(chunk, args[0].shape[1]))
    before = mc.LAUNCHES
    h, (S_fin, n_fin) = mc.mlstm_chunk(*args, state=state, chunk=chunk)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == before + 1
    h_p, (S_p, n_p) = mc.mlstm_chunk_plain(*args, state=state, chunk=chunk)
    torch.testing.assert_close(S_fin, S_p, **TOL, msg=lambda m: f"{route}: S {m}")
    torch.testing.assert_close(n_fin, n_p, **TOL, msg=lambda m: f"{route}: n {m}")
    if dtype == torch.float32:
        torch.testing.assert_close(h, h_p, **TOL, msg=lambda m: f"{route}: h {m}")
    else:
        err = (h.float() - h_p.float()).abs()
        assert bool((err <= 2**-7 * h_p.float().abs() + 2e-4).all()), (route, float(err.max()))
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "BH,S,D,chunk",
    REF_CASES + [
        (16, 1, 512, 256), (16, 768, 512, 256), (16, 640, 512, 128), (4, 40, 16, 8),
        (3, 96, 128, 48),                                   # a chunk below 64, not a multiple of 16
        (2, 64, 32, 1), (2, 12, 16, 1), (2, 16, 128, 1),    # chunks of one over S positions
    ],
)
def test_kernel_matches_plain(cuda, BH, S, D, chunk, dtype, carried):
    """Every route against the twin (`plan` gives the route: bf16 prefill
    at Dh 64-512 on mma, C = 1 on stream, the rest on simt)."""
    args = _t(_inputs(BH, S, D, seed=S * D), dtype, cuda)
    state = tuple(t.to(cuda) for t in map(torch.from_numpy, _state(BH, D, seed=D))) if carried else None
    _matches_plain(args, state, chunk, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_a_padded_prompt(cuda, dtype):
    """xLSTM's served prompt: 600 rows padded to 768 as the model pads
    them, chunks of 256, a carried state."""
    args = _pad_like_the_model(_t(_inputs(16, 600, 512, seed=600), dtype, cuda), 256)
    assert args[0].shape[1] == 768
    state = tuple(t.to(cuda) for t in map(torch.from_numpy, _state(16, 512, seed=6)))
    h = _matches_plain(args, state, 256, dtype)
    assert bool((h[:, 600:] == 0).all())  # zero q: padded rows add nothing
