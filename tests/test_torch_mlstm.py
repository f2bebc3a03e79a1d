"""`repro_torch.kernels.mlstm_chunk` on the host: the plain twin (which the
wrapper takes for CPU tensors) against the reference's naive recurrence
``mlstm_ref``, its interpret-mode Pallas kernel ``mlstm_chunk_pallas`` and
the model's chunkwise form ``_mlstm_chunk_scan``; the kernel against the
twin on the card (marked ``cuda``; they skip without one).

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
    """Prefill (C = 256) and decode (C = 1) at Dh = 512 fit a block's shared
    memory on the card; the reference's widest case (Dh = 128, C = 128) too.
    A chunk that does not fit is refused, naming the shared memory."""
    dev = torch.cuda.current_device()
    for Dh, C in ((512, 256), (512, 1), (128, 128)):
        need, limit = mc.block_smem(dev, Dh, C)
        assert 0 < need <= limit, (Dh, C, need, limit)
    big = _t(_inputs(1, 4096, 512), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mc.mlstm_chunk(*big, chunk=4096)


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "BH,S,D,chunk", REF_CASES + [(16, 1, 512, 256), (16, 768, 512, 256), (4, 40, 16, 8)]
)
def test_kernel_matches_plain(cuda, BH, S, D, chunk, dtype, carried):
    args = _t(_inputs(BH, S, D, seed=S * D), dtype, cuda)
    state = tuple(t.to(cuda) for t in map(torch.from_numpy, _state(BH, D, seed=D))) if carried else None
    before = mc.LAUNCHES
    h, (S_fin, n_fin) = mc.mlstm_chunk(*args, state=state, chunk=chunk)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == before + 1
    h_p, (S_p, n_p) = mc.mlstm_chunk_plain(*args, state=state, chunk=chunk)
    torch.testing.assert_close(S_fin, S_p, **TOL)
    torch.testing.assert_close(n_fin, n_p, **TOL)
    if dtype == torch.float32:
        torch.testing.assert_close(h, h_p, **TOL)
    else:
        err = (h.float() - h_p.float()).abs()
        assert bool((err <= 2**-7 * h_p.float().abs() + 2e-4).all()), float(err.max())
