"""`repro_torch.models.moe` against the JAX package's `repro.models.moe`,
on the host, given the same parameters and inputs.

Tolerances:
  * `moe_apply` in f32: 2e-5 absolute and relative (products summed in
    another order; every routing decision equal);
  * in bf16: 3e-2 absolute and relative, a few bf16 units at outputs of
    order 1 (the frameworks round the products' outputs at other places);
  * gradients of a weighted sum of the output, leaf by leaf: 1e-4 of the
    leaf's largest reference value in f32, 0.1 of it in bf16, the bounds
    of `tests/test_torch_train.py`;
  * the chosen experts, their ranks and which pairs are kept: equal.

The dispatch runs with G = 1 (64 tokens) and with G = 2 (``moe_groups=2``
and 512 tokens, 256 a group, the least the reference splits), at the
reduced configs' capacity factor and at 0.5, which forces drops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch.models import moe

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _cfg(dtype="float32", arch="qwen3-moe-235b-a22b", **kw):
    """A reduced MoE config (4 experts, top 2 at reduced widths) with the
    experts, top k and groups given."""
    return REF_ARCHS[arch].reduced(compute_dtype=dtype, **kw)


def _case(cfg, tokens, seed=0):
    """Reference parameters (f32) and an input of ``tokens`` tokens in the
    compute dtype, and their torch copies."""
    p = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, tokens // 2, cfg.d_model)).astype(np.float32)
    cdt = getattr(jnp, cfg.compute_dtype)
    x_ref = jnp.asarray(x).astype(cdt)
    port_p = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x_port = torch.from_numpy(np.array(x_ref.astype(jnp.float32))).to(
        getattr(torch, cfg.compute_dtype))
    return p, x_ref, port_p, x_port


def _ref_choices(p, x, cfg):
    """The reference's routing, step by step as `repro.models.moe.moe_apply`
    computes it: experts, ranks and keep mask, (G, Tg, K) each."""
    B, S, D = x.shape
    T = B * S
    G = ref_moe._num_groups(cfg, T)
    C = ref_moe.moe_capacity(T // G, cfg)
    h = ref_layers.rms_norm(x, p["norm"]).reshape(G, T // G, D)
    logits = (h @ p["w_router"].astype(x.dtype)).astype(jnp.float32)
    _, gate_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    onehot = jax.nn.one_hot(gate_e, cfg.num_experts, dtype=jnp.int32).reshape(
        G, -1, cfg.num_experts)
    rank = ((jnp.cumsum(onehot, axis=1) - onehot) * onehot).sum(-1).reshape(gate_e.shape)
    return np.asarray(gate_e), np.asarray(rank), np.asarray(rank < C)


def _port_choices(port_p, x, cfg):
    B, S, D = x.shape
    G = moe._num_groups(cfg, B * S)
    C = moe.moe_capacity(B * S // G, cfg)
    h = moe.rms_norm(x, port_p["norm"]).reshape(G, -1, D)
    _, gate_e, rank, keep = moe.route(h, port_p["w_router"], cfg, C)
    return gate_e.numpy(), rank.numpy(), keep.numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_capacity_and_groups_match_reference():
    for arch in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        for cf in (0.5, 1.25, 4.0, 16.0):
            cfg = dataclasses.replace(REF_ARCHS[arch], capacity_factor=cf)
            for tg in (1, 4, 7, 64, 150, 599, 600, 2400, 4096):
                assert moe.moe_capacity(tg, cfg) == ref_moe.moe_capacity(tg, cfg)
        for T in (4, 256, 2396, 2400, 4096, 4 * 1024, 8192, 4 * 600):
            assert moe._num_groups(REF_ARCHS[arch], T) == ref_moe._num_groups(REF_ARCHS[arch], T)
    # The serving and training shapes of the smoke run.
    assert moe._num_groups(REF_ARCHS["qwen3-moe-235b-a22b"], 4 * 600) == 1
    assert moe._num_groups(REF_ARCHS["qwen3-moe-235b-a22b"], 4 * 1024) == 16


@pytest.mark.parametrize("cf", [None, 0.5], ids=["no-drop", "drops"])
@pytest.mark.parametrize("groups,tokens", [(16, 64), (2, 512)], ids=["G1", "G2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(dtype, groups, tokens, cf):
    kw = {"moe_groups": groups} | ({} if cf is None else {"capacity_factor": cf})
    cfg = _cfg(dtype, **kw)
    p, x_ref, port_p, x_port = _case(cfg, tokens)
    want = ref_moe.moe_apply(p, x_ref, cfg)
    got = moe.moe_apply(port_p, x_port, cfg)
    assert got.dtype == x_port.dtype and got.shape == x_port.shape
    _close(got, want, TOL[dtype])
    G = moe._num_groups(cfg, tokens)
    assert G == (2 if tokens == 512 else 1)
    e, r, keep = _port_choices(port_p, x_port, cfg)
    want_e, want_r, want_keep = _ref_choices(p, x_ref, cfg)
    assert e.shape == (G, tokens // G, cfg.top_k)
    np.testing.assert_array_equal(e, want_e)
    np.testing.assert_array_equal(r, want_r)
    np.testing.assert_array_equal(keep, want_keep)
    assert keep.all() == (cf is None)  # 0.5 drops pairs, the reduced 4.0 none


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [None, 0.5], ids=["no-drop", "drops"])
def test_moe_gradients_match_reference(dtype, cf):
    """Gradients of sum(out * w) in every parameter and the input, G = 2:
    through the router's softmax and the gates, the experts and the
    dispatch, against ``jax.grad``."""
    kw = {"moe_groups": 2} | ({} if cf is None else {"capacity_factor": cf})
    cfg = _cfg(dtype, **kw)
    p, x_ref, port_p, x_port = _case(cfg, 512, seed=3)
    w = np.random.default_rng(9).standard_normal(x_port.shape).astype(np.float32)

    def ref_obj(p, x):
        return (ref_moe.moe_apply(p, x, cfg).astype(jnp.float32) * w).sum()

    want = jax.grad(ref_obj, argnums=(0, 1))(p, x_ref)
    leaves = {k: v.clone().requires_grad_() for k, v in port_p.items()}
    x = x_port.clone().requires_grad_()
    obj = (moe.moe_apply(leaves, x, cfg).to(torch.float32) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(obj, [*leaves.values(), x])
    pairs = [(g, want[0][k]) for g, k in zip(grads, leaves)] + [(grads[-1], want[1])]
    for g, r in pairs:
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        assert g.shape == r.shape
        err = float((g.to(torch.float32) - torch.from_numpy(r)).abs().max())
        assert err <= GRAD_TOL[dtype] * float(np.abs(r).max()), err
        assert bool(g.any())


def _tied_case():
    """A bf16 router whose columns repeat (experts 1, 2 and 4 share one,
    3 and 6 another), so that equal logits, and so equal probabilities,
    occur on every token, exactly in both frameworks."""
    cfg = _cfg("bfloat16", num_experts=8, top_k=2, capacity_factor=8.0)
    p, x_ref, port_p, x_port = _case(cfg, 64, seed=5)
    cols = np.asarray(p["w_router"])[:, [0, 1, 1, 3, 1, 5, 3, 7]]
    cols[:, [1, 2, 4]] += 0.3  # the shared column usually among the top 2
    p = {**p, "w_router": jnp.asarray(cols)}
    port_p = {**port_p, "w_router": torch.from_numpy(cols.copy())}
    return cfg, p, x_ref, port_p, x_port


def _check_ties(cfg, p, x_ref, port_p, x_port):
    want_e, _, _ = _ref_choices(p, x_ref, cfg)
    got_e, _, _ = _port_choices(port_p, x_port, cfg)
    tied = (want_e[..., 0] == 1) | (want_e[..., 1] == 2)
    assert tied.mean() > 0.3  # ties decide many choices here
    np.testing.assert_array_equal(got_e, want_e)
    _close(moe.moe_apply(port_p, x_port, cfg), ref_moe.moe_apply(p, x_ref, cfg),
           TOL["bfloat16"])


@pytest.mark.parametrize("impl", ["stable sort", "torch.topk"])
def test_router_ties_break_as_lax_top_k(impl, monkeypatch):
    """Equal probabilities go to the lower expert, as ``jax.lax.top_k``
    picks them.  The same check on a port that took ``torch.topk`` fails:
    it breaks ties otherwise."""
    case = _tied_case()
    if impl == "stable sort":
        _check_ties(*case)
        return
    monkeypatch.setattr(moe, "top_k", lambda probs, k: torch.topk(probs, k))
    with pytest.raises(AssertionError):
        _check_ties(*case)


def test_top_k_orders_as_lax_top_k():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]])
    values, index = moe.top_k(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(index.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))


def test_moe_init_shapes_and_dtype():
    cfg = _cfg()
    g = torch.Generator().manual_seed(0)
    p = moe.moe_init(g, cfg, torch.bfloat16)
    ref = ref_moe.moe_init(jax.random.PRNGKey(0), cfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in ref.items()}
    assert p["w_gate"].dtype == torch.bfloat16 and p["w_router"].dtype == torch.float32
    assert abs(float(p["w_down"].float().std()) * cfg.d_ff**0.5 - 1.0) < 0.1
