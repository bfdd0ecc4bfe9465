"""The port's CUDA kernels (B1, B2, B3, B6) against their plain PyTorch
versions, on the card.  These tests skip without a CUDA device.  This file
imports neither jax nor the JAX package, so on a machine with a card and no
jax it runs with ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: in float64 the kernels differ from the plain versions only by
summation order (1e-12 of the largest entry).  In float32, B1's and B2's
per-camera sums are float atomics and B3 sums over L·dl terms in another
order than the float64 yardstick: all are held to 1e-5 of the largest
entry.  B6 sums each run in a fixed order: 1e-12 (float64) and 1e-5
(float32) of the largest entry against the float64 plain version.
"""

import numpy as np
import pytest
import torch

from nllstpu_torch.ops import fused_obs, schur_reduce, segment_sum


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(a, b):
    b64 = b.double()
    return float((a.double() - b64).abs().max() / b64.abs().max().clamp_min(1e-300))


def _b1_inputs(gen, K, L, n_r, dr_s, device, dtype):
    s = dr_s + 3
    jac = torch.randn(2, s, K, L, generator=gen, dtype=torch.float64)
    g0 = torch.randn(s, K, L, generator=gen, dtype=torch.float64)
    d1 = torch.rand(K, L, generator=gen, dtype=torch.float64) + 0.05
    d2 = -0.2 * torch.rand(K, L, generator=gen, dtype=torch.float64)
    vc = torch.randint(0, n_r, (K, L), generator=gen, dtype=torch.int32)
    vc[1] = vc[0]
    pad = torch.zeros(K, L, dtype=torch.bool)
    pad[K - 1, ::3] = True
    vc[pad] = n_r
    d1[pad] = 0.0
    d2[pad] = 0.0
    return [t.to(device=device, dtype=dtype) for t in (jac, g0, d1, d2)] + [vc.to(device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize(
    "dr_s,e_start,n_r",
    # n_r = 300 at dr_s = 9 overflows the shared-memory camera accumulator
    # and takes the device-memory atomics path.
    [(6, 6, 37), (6, 0, 37), (9, 9, 300)],
)
def test_fused_obs_kernel_matches_plain(cuda, dtype, tol, dr_s, e_start, n_r):
    gen = torch.Generator().manual_seed(11)
    inputs = _b1_inputs(gen, 14, 1000, n_r, dr_s, cuda, dtype)
    before = fused_obs.LAUNCHES
    out = fused_obs.fused_obs_all(*inputs, n_r, dr_s, 3, e_start)
    torch.cuda.synchronize()
    assert fused_obs.LAUNCHES == before + 1
    ref = fused_obs.fused_obs_all_reference(
        *[t.double() if t.is_floating_point() else t for t in inputs],
        n_r, dr_s, 3, e_start,
    )
    for name, a, b in zip(("h_ll", "g_l", "w", "ab"), out, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize(
    "dr_s,e_start,n_r",
    # n_r = 300 at dr_s = 9 takes the device-memory atomics path.
    [(9, 9, 37), (6, 0, 37), (9, 9, 300)],
)
def test_fused_obs_into_kernel_matches_plain(cuda, dtype, tol, dr_s, e_start, n_r):
    """B2 over a degree-bucketed plan: a chunk bucket over the heavy prefix,
    the class bucket that covers it again, and a class bucket at an
    unaligned l_base, all adding into buffers that start non-zero."""
    gen = torch.Generator().manual_seed(13)
    L, dl = 1000, 3
    calls = [(16, 0, 57), (14, 0, 300), (4, 337, 600)]  # (K, l_base, L_b)
    npairs = dr_s * (dr_s + 1) // 2
    init = [
        torch.randn(shape, generator=gen, dtype=torch.float64)
        for shape in ((dl, dl, L), (dl, L), (L, dl, n_r * dr_s), (npairs + dr_s, n_r))
    ]
    init[0] = init[0] + init[0].transpose(0, 1)
    got = [t.to(device=cuda, dtype=dtype) for t in init]
    ref = [t.to(device=cuda) for t in init]
    before, before_b1 = fused_obs.INTO_LAUNCHES, fused_obs.LAUNCHES
    for K, l_base, lb in calls:
        inputs = _b1_inputs(gen, K, lb, n_r, dr_s, cuda, dtype)
        fused_obs.fused_obs_all_into(*inputs, *got, l_base, n_r, dr_s, dl, e_start)
        fused_obs.fused_obs_all_into_reference(
            *[t.double() if t.is_floating_point() else t for t in inputs], *ref,
            l_base, n_r, dr_s, dl, e_start,
        )
    torch.cuda.synchronize()
    assert fused_obs.INTO_LAUNCHES == before + len(calls)
    assert fused_obs.LAUNCHES == before_b1
    for name, a, b, c in zip(("h_ll", "g_l", "w", "ab"), got, ref, init):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
        assert _rel_err(b, c.to(cuda)) > 1e-3, name  # every buffer was added to


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
# wc = 441 is Ladybug-49's W (49 Snavely cameras), not a multiple of the
# kernel's 64-wide tile.
@pytest.mark.parametrize(
    "wc,lam", [(128, 0.0), (768, 1e-2), (1152, 0.0), (100, 0.5), (441, 1e-2)]
)
def test_reduce_s_damped_kernel_matches_plain(cuda, dtype, tol, wc, lam):
    gen = torch.Generator().manual_seed(5)
    L, dl = 777, 3
    w = torch.randn(L, dl, wc, generator=gen, dtype=torch.float64)
    a = torch.randn(dl, dl, L, generator=gen, dtype=torch.float64)
    h_ll = torch.einsum("del,fel->dfl", a, a) + 2.0 * torch.eye(dl, dtype=torch.float64)[:, :, None]
    g_l = torch.randn(dl, L, generator=gen, dtype=torch.float64)
    before = schur_reduce.LAUNCHES
    out = schur_reduce.reduce_s_damped(
        *(t.to(device=cuda, dtype=dtype) for t in (w, h_ll, g_l)), lam
    )
    torch.cuda.synchronize()
    assert schur_reduce.LAUNCHES == before + 1
    ref = schur_reduce.reduce_s_damped_reference(
        *(t.to(device=cuda) for t in (w, h_ll, g_l)), lam
    )
    for name, x, y in zip(("s_sum", "rhs_sum", "h_inv"), out, ref):
        assert x.shape == y.shape, name
        assert _rel_err(x, y) <= tol, (name, _rel_err(x, y))
    # The mirrored lower triangle equals the computed upper one.
    s = out[0].double()
    assert float((s - s.T).abs().max() / s.abs().max()) <= 10 * tol


def _b6_case(gen, n_runs, d, long_run):
    """Skewed runs: empty ones, one of ``long_run`` rows, and rows before
    the first and after the last run that must be ignored."""
    lengths = torch.randint(0, 40, (n_runs,), generator=gen)
    lengths[::7] = 0
    lengths[n_runs // 2] = long_run
    starts = 5 + torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)])
    data = torch.randn(int(starts[-1]) + 9, d, generator=gen, dtype=torch.float64)
    return data, starts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
# D of the implicit path: Wᵀv, W u, h_ll + g_l, a_rr + b_r, the
# preconditioner's correction; one run of 100,000 rows.
@pytest.mark.parametrize("d", [3, 9, 12, 54, 81])
def test_segment_block_sum_kernel_matches_plain(cuda, dtype, tol, index, d):
    gen = torch.Generator().manual_seed(d)
    data, starts = _b6_case(gen, 300, d, 100_000)
    before = segment_sum.LAUNCHES
    out = segment_sum.segment_block_sum(data.to(cuda, dtype), starts.to(cuda, index))
    torch.cuda.synchronize()
    assert segment_sum.LAUNCHES == before + 1
    ref = segment_sum.segment_block_sum_reference(data, starts)
    assert out.shape == ref.shape and out.dtype == dtype
    assert _rel_err(out.cpu(), ref) <= tol
    empty = (starts[1:] == starts[:-1]).nonzero()[:, 0]
    assert len(empty) and not out[empty.to(cuda)].any()
    # Deterministic: the same bits on a second launch.
    again = segment_sum.segment_block_sum(data.to(cuda, dtype), starts.to(cuda, index))
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda):
    w = torch.zeros(4, 5, 6, device=cuda)
    with pytest.raises(ValueError):
        schur_reduce.reduce_s_damped(w, torch.zeros(3, 3, 4, device=cuda), torch.zeros(3, 4, device=cuda), 0.0)
    jac = torch.zeros(3, 9, 2, 4, device=cuda)
    with pytest.raises(ValueError):
        fused_obs.fused_obs_all(
            jac, torch.zeros(9, 2, 4, device=cuda), torch.zeros(2, 4, device=cuda),
            torch.zeros(2, 4, device=cuda), torch.zeros(2, 4, dtype=torch.int32, device=cuda),
            5, 6, 3, 6,
        )
    with pytest.raises(ValueError):
        segment_sum.segment_block_sum(w, torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        segment_sum.segment_block_sum(w[0], torch.zeros(3, device=cuda))


def test_plain_versions_run_on_cpu():
    """The CPU half of this file: both plain versions produce the shapes
    the kernels promise."""
    gen = torch.Generator().manual_seed(2)
    inputs = _b1_inputs(gen, 3, 10, 4, 6, "cpu", torch.float64)
    h, g, w, ab = fused_obs.fused_obs_all(*inputs, 4, 6, 3, 6)
    assert (h.shape, g.shape, w.shape, ab.shape) == (
        (3, 3, 10), (3, 10), (10, 3, 24), (27, 4)
    )
    assert torch.allclose(h, h.transpose(0, 1), rtol=1e-14, atol=0)
    s, r, hi = schur_reduce.reduce_s_damped(w, h + 5 * torch.eye(3, dtype=h.dtype)[:, :, None], g, 0.1)
    assert (s.shape, r.shape, hi.shape) == ((24, 24), (24,), (3, 3, 10))
    assert np.isfinite(s.numpy()).all()
    data, starts = _b6_case(gen, 12, 5, 70)
    out = segment_sum.segment_block_sum(data, starts)
    assert out.shape == (12, 5)
    for i in range(12):
        assert torch.allclose(out[i], data[starts[i]:starts[i + 1]].sum(0), rtol=1e-14, atol=1e-14)
