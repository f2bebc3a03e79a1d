"""The sLSTM's time loop in training (`repro_torch.models.xlstm._SlstmScan`),
on the host:

  * its hand-written backward against autograd through the same loop run
    step by step (`_slstm_scan`), in f64, within 1e-12 of each gradient's
    largest magnitude: the pre-activations, the recurrent kernel and the
    initial state, with gradients reaching every output and the final
    state, the input gate's clamp and the normalizer's ``max(|n|, 1)``
    active on some entries and not on others;
  * its forward bit for bit against the loop without autograd (f32), the
    outputs and the final state.
"""

import pytest
import torch

from repro_torch.models.xlstm import _slstm_scan, _SlstmScan

# The suite runs several worker processes on few cores: one intra-op
# thread each keeps PyTorch's small CPU ops from oversubscribing them.
torch.set_num_threads(1)

B, S, H, Dh = 3, 7, 2, 4


def _inputs(dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    pre = torch.randn((B, S, H, 4 * Dh), generator=gen, dtype=dtype) * 4.0
    # Input-gate pre-activations below the clamp at -10 on many entries,
    # so that the normalizer n stays under 1 on some and not on others.
    pre[..., Dh:2 * Dh] = pre[..., Dh:2 * Dh] * 2.0 - 12.0
    r = torch.randn((H, Dh, 4 * Dh), generator=gen, dtype=dtype) * Dh**-0.5
    state = tuple(torch.randn((B, H, Dh), generator=gen, dtype=dtype) for _ in range(3))
    return pre, r, state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_matches_autograd_through_the_loop(seed):
    pre, r, state = _inputs(torch.float64, seed)
    leaves = [t.clone().requires_grad_() for t in (pre, r, *state)]
    gen = torch.Generator().manual_seed(100 + seed)
    weights = [torch.randn((B, S, H, Dh), generator=gen, dtype=torch.float64)] + [
        torch.randn((B, H, Dh), generator=gen, dtype=torch.float64) for _ in range(3)]

    def loss(outs):
        return sum((o * w).sum() for o, w in zip(outs, weights))

    got = torch.autograd.grad(loss(_SlstmScan.apply(*leaves)), leaves)
    want = torch.autograd.grad(loss(_slstm_scan(*leaves, Dh)), leaves)
    i_gate = pre[..., Dh:2 * Dh]
    assert bool((i_gate.abs() > 10).any()) and bool((i_gate.abs() < 10).any())
    with torch.no_grad():
        n = _slstm_scan(pre, r, *state, Dh)[2]
    assert bool((n.abs() < 1).any()) and bool((n.abs() > 1).any())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


def test_forward_is_the_loop_bit_for_bit():
    pre, r, state = _inputs(torch.float32, 3)
    with torch.no_grad():
        want = _slstm_scan(pre, r, *state, Dh)
    got = _SlstmScan.apply(pre.requires_grad_(), r, *state)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.detach(), w)
