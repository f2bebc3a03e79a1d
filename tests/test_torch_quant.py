"""`repro_torch.kernels.quant` and `repro_torch.runtime.compression` on the
host, against the JAX package's int8 quantizer (`repro.kernels.quant`:
``quantize_ref`` / ``dequantize_ref``, interpret-mode ``quantize_pallas`` /
``dequantize_pallas`` and the flat API) and its gradient compression
(`repro.runtime.compression`); the kernels against their twins on the card
(marked ``cuda``; they skip without one).

Tolerance: none against the reference's oracle.  Every step is one IEEE
f32 operation, so given the same noise the outputs are bit-identical to
``quantize_ref`` / ``dequantize_ref`` (and so to NumPy): q, scales,
dequantized values, the compression payload and the new error feedback.
The port cannot draw ``jax.random``'s numbers, so the reference's noise is
drawn with JAX and handed to the port.

The interpret-mode Pallas kernel is jitted as a whole, and XLA on the host
rewrites its ``amax / 127.0`` (a division by a constant) into a product
with the rounded reciprocal: its scales differ from IEEE division by one
ulp on some rows (the reference's own test holds its kernel to its oracle
with ``rtol=1e-6`` on scales).  Against it: q identical, scales within one
ulp, and its dequantize of the port's (q, scale) identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels.quant import dequantize_flat as ref_dequantize_flat
from repro.kernels.quant import quantize_flat as ref_quantize_flat
from repro.kernels.quant.kernel import dequantize_pallas, quantize_pallas
from repro.kernels.quant.ref import dequantize_ref, quantize_ref
from repro.models.model import build_model as ref_build_model
from repro.runtime import compression as ref_comp
from repro_torch import tree
from repro_torch.kernels import common
from repro_torch.kernels import quant as qt
from repro_torch.runtime import compression as comp

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

# The reference's cases (`tests/test_kernels.py::test_quant_matches_ref`).
REF_CASES = [(4, 128), (64, 512), (33, 300), (1, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(R, C, seed, zero_rows=()):
    """The reference test's inputs (x ~ 3 N(0, 1), noise U[0, 1)), with
    the listed rows of x set to zero."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((R, C)) * 3.0).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x, rng.random((R, C)).astype(np.float32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _as_pallas(q: torch.Tensor, s: torch.Tensor, q_p, s_p) -> None:
    """The port's (q, scale) against interpret-mode Pallas: q identical,
    scales within one ulp (XLA's reciprocal product, module docstring)."""
    _same(q, q_p)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(s_p), maxulp=1)


# ------------------------------------------------------------------ twins
@pytest.mark.parametrize("R,C", REF_CASES)
def test_twins_bit_identical_to_reference_and_pallas(R, C):
    x, noise = _inputs(R, C, seed=R * 7 + C, zero_rows=(0,) if R > 1 else ())
    q, s = qt.quantize(torch.from_numpy(x), torch.from_numpy(noise))
    d = qt.dequantize(q, s)
    q_r, s_r = quantize_ref(jnp.asarray(x), jnp.asarray(noise))
    _same(q, q_r)
    _same(s, s_r)
    _same(d, dequantize_ref(q_r, s_r))
    _as_pallas(q, s, *quantize_pallas(jnp.asarray(x), jnp.asarray(noise), interpret=True))
    _same(d, dequantize_pallas(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), interpret=True))


def test_twins_on_zero_and_subnormal_rows():
    """An all-zero row takes the 1e-30 floor (q = floor(noise) = 0); rows
    of subnormals and of tiny normals keep their exact IEEE scales."""
    C = 128
    rng = np.random.default_rng(3)
    rows = [
        np.zeros(C),
        rng.standard_normal(C) * 1e-40,  # subnormal x
        rng.standard_normal(C) * 1e-36,  # a scale below 1e-30's floor
        rng.standard_normal(C) * 1e-25,
        rng.standard_normal(C) * 1e30,
    ]
    x = np.stack(rows).astype(np.float32)
    noise = rng.random(x.shape).astype(np.float32)
    q, s = qt.quantize_plain(torch.from_numpy(x), torch.from_numpy(noise))
    q_r, s_r = quantize_ref(jnp.asarray(x), jnp.asarray(noise))
    _same(q, q_r)
    _same(s, s_r)
    _same(qt.dequantize_plain(q, s), dequantize_ref(q_r, s_r))
    assert s[0] == np.float32(1e-30) and not q[0].any()


@pytest.mark.parametrize("n", [1, 511, 512, 1152, 3 * 512 + 17])
def test_flat_api_matches_reference(n):
    """`quantize_flat` pads with zeros to rows = max(1, ceil(n / 512)) and,
    given the reference's ``jax.random.uniform(key, (rows, 512))``, gives
    its bits (kernel route in interpret mode and the jnp route)."""
    x = (np.random.default_rng(n).standard_normal(n) * 0.01).astype(np.float32)
    key = jax.random.PRNGKey(n)
    rows = qt.flat_rows(n)
    assert rows == max(1, -(-n // qt.CHUNK))
    noise = np.array(jax.random.uniform(key, (rows, qt.CHUNK), jnp.float32))
    q, s, m = qt.quantize_flat(torch.from_numpy(x), torch.from_numpy(noise))
    assert m == n and q.shape == (rows, qt.CHUNK)
    out = qt.dequantize_flat(q, s, n)
    q_r, s_r, n_r = ref_quantize_flat(jnp.asarray(x), key, use_kernel=False)
    assert n_r == n
    _same(q, q_r)
    _same(s, s_r)
    _same(out, ref_dequantize_flat(q_r, s_r, n_r, use_kernel=False))
    q_p, s_p, _ = ref_quantize_flat(jnp.asarray(x), key, use_kernel=True)
    _as_pallas(q, s, q_p, s_p)
    port_qs = (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    _same(out, ref_dequantize_flat(*port_qs, n, use_kernel=True))


def test_flat_api_draws_from_a_generator():
    """A generator draws (rows, 512) uniform noise: the same seed gives the
    same payload, and the padding quantizes to zeros."""
    x = torch.randn(700, generator=torch.Generator().manual_seed(0))
    a = qt.quantize_flat(x, torch.Generator().manual_seed(5))
    b = qt.quantize_flat(x, torch.Generator().manual_seed(5))
    assert all(torch.equal(u, v) for u, v in zip(a[:2], b[:2]))
    assert not a[0].view(-1)[700:].any()


def test_wrappers_check_operands():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="one shape"):
        qt.quantize(x, torch.zeros((2, 4)))
    with pytest.raises(TypeError, match="float32"):
        qt.quantize(x.double(), x.double())
    with pytest.raises(ValueError, match="unsupported device"):
        qt.quantize(x.to("meta"), x.to("meta"))
    with pytest.raises(TypeError, match="int8"):
        qt.dequantize(torch.zeros((2, 8), dtype=torch.int32), torch.zeros(2))


def test_refuse_grad_names_the_kernel():
    """The check every ctypes kernel wrapper with no backward makes before
    its launch (reached only for CUDA operands): an operand that requires
    grad raises while autograd records, and passes under no_grad."""
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="mlstm_chunk: the CUDA kernel has no backward"):
        common.refuse_grad("mlstm_chunk", torch.zeros(2), t)
    with torch.no_grad():
        common.refuse_grad("mlstm_chunk", t)
    common.refuse_grad("quantize", torch.zeros(2), None)


# ------------------------------------------------------------ compression
def _ref_tree():
    """The reference's reduced gemma3 parameter tree (stacked units and
    remainder layers) as gradient-like leaves, flattened in its order."""
    cfg = REF_ARCHS["gemma3-1b"].reduced(num_layers=14, d_model=80, head_dim=20)
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(params)
    rng = np.random.default_rng(11)
    grads = [(rng.standard_normal(np.shape(p)) * 1e-3).astype(np.float32) for p in leaves]
    errors = [(rng.standard_normal(np.shape(p)) * 1e-5).astype(np.float32) for p in leaves]
    return jax.tree.structure(params), grads, errors


def test_compress_tree_bit_identical_to_reference():
    """Payload (q, scales, n) and new error feedback on the reference's own
    leaves (its stacked tree), each leaf's noise drawn as the reference
    draws it; then the restored gradients.

    The reference's ``decompress_tree`` finds its payload triples with
    ``is_leaf=tuple``, which on the model's tree also takes the ``units``
    and ``rem`` tuples for triples and fails; it is called here on the
    flat list of triples, where it does what it means to."""
    treedef, grads, errors = _ref_tree()
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    ref_payload, ref_err = ref_comp.compress_tree(
        jax.tree.unflatten(treedef, [jnp.asarray(g) for g in grads]),
        jax.tree.unflatten(treedef, [jnp.asarray(e) for e in errors]),
        key,
        use_kernel=False,
    )
    ref_payload = treedef.flatten_up_to(ref_payload)
    ref_err = jax.tree.leaves(ref_err)
    noise = [
        torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, i), (qt.flat_rows(g.size), qt.CHUNK), jnp.float32
        )))
        for i, g in enumerate(grads)
    ]
    payload, new_err = comp.compress_tree(
        [torch.from_numpy(g) for g in grads], [torch.from_numpy(e) for e in errors], noise
    )
    assert len(payload) == len(ref_payload) == len(grads)
    for (q, s, n), (q_r, s_r, n_r) in zip(payload, ref_payload):
        assert n == n_r
        _same(q, q_r)
        _same(s, s_r)
    for e, e_r in zip(new_err, ref_err):
        _same(e, e_r)
    restored = comp.decompress_tree(payload, [torch.from_numpy(g) for g in grads])
    ref_restored = ref_comp.decompress_tree(
        list(ref_payload), [jnp.asarray(g) for g in grads], use_kernel=False
    )
    for r, r_ref in zip(restored, ref_restored):
        _same(r, r_ref)


def test_compression_on_nested_trees():
    """Nested dicts and lists keep their structure; leaves flatten as
    ``jax.tree`` does (sorted keys); a generator's noise is drawn leaf by
    leaf, so the same seed gives the same exchange; one quantize and two
    dequantize per leaf (plain twins here: no launches counted)."""
    g = torch.Generator().manual_seed(0)
    grads = {"b": [torch.randn(3, 5, generator=g)], "a": torch.randn(600, generator=g)}
    errors = comp.init_error_feedback(grads)
    assert tree.leaves(errors)[0].shape == (600,) and not tree.leaves(errors)[0].any()
    restored, new_err = comp.compressed_allreduce(grads, errors, torch.Generator().manual_seed(1))
    again, _ = comp.compressed_allreduce(grads, errors, torch.Generator().manual_seed(1))
    assert set(restored) == {"a", "b"} and restored["b"][0].shape == (3, 5)
    for r, a in zip(tree.leaves(restored), tree.leaves(again)):
        assert torch.equal(r, a)
    for gl, rl, el in zip(tree.leaves(grads), tree.leaves(restored), tree.leaves(new_err)):
        assert torch.equal(gl - rl, el)  # the residual is the next step's error
        step = gl.abs().max() / 127
        assert bool((el.abs() <= step * (1 + 2**-16)).all())
    assert qt.LAUNCHES_QUANTIZE == 0 and qt.LAUNCHES_DEQUANTIZE == 0
    with pytest.raises(RuntimeError, match="no process group"):
        comp.compressed_allreduce(grads, errors, torch.Generator(), axis_name="pod")
    with pytest.raises(ValueError, match="noise tensors"):
        comp.compress_tree(grads, errors, [torch.zeros(2, 512)])


# ------------------------------------------------------------- on the card
def _card_cases():
    """The reference's cases, the embedding's rows (262144 x 1152 / 512),
    a norm leaf's (1152 values: 3 rows, the last padded) and a zero row."""
    return REF_CASES + [(589_824, 512), (3, 512), (5, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", _card_cases())
def test_kernels_equal_their_twins(cuda, R, C):
    x, noise = _inputs(R, C, seed=R + C, zero_rows=(R - 1,) if R > 1 else ())
    if (R, C) == (3, 512):
        x[2, 128:] = 0.0  # a norm leaf of 1152 values, zero-padded
    xt, nt = torch.from_numpy(x).to(cuda), torch.from_numpy(noise).to(cuda)
    q, s = qt.quantize(xt, nt)
    d = qt.dequantize(q, s)
    torch.cuda.synchronize()
    q_p, s_p = qt.quantize_plain(xt, nt)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert torch.equal(d, qt.dequantize_plain(q_p, s_p))


@pytest.mark.cuda
def test_kernels_refuse_grad_and_count(cuda):
    x = torch.randn((4, 512), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        qt.quantize(x, torch.rand((4, 512), device=cuda))
    before = (qt.LAUNCHES_QUANTIZE, qt.LAUNCHES_DEQUANTIZE)
    q, s = qt.quantize(x.detach(), torch.rand((4, 512), device=cuda))
    qt.dequantize(q, s)
    assert (qt.LAUNCHES_QUANTIZE, qt.LAUNCHES_DEQUANTIZE) == (before[0] + 1, before[1] + 1)
