"""Kernel E's factored arithmetic (csrc/adaptive.cu), emulated on the CPU.

The CUDA kernel cannot run here, so this file checks its algebra: a plain
f32 torch function that sums in the kernel's order, held against the JAX
package's float64 oracle (``core/oracle.adaptive_bicubic_oracle``), its jnp
graph (``ops/adaptive.adaptive_resize(impl="jnp")``) and the port's plain
version (``ops/adaptive_fused.adaptive_resize_reference``), which stays the
package's reference.

The factoring. Inside one centre variant (cy, cx) the factors f[n][m] are
fixed, so per row phase q the kernel forms a[n][m] = wy[n] * f[n][m], the
column sums u[m][ch] = sum_n a[n][m] * pix[n][m][ch] and us[m] = sum_n
a[n][m], and per column phase p only acc[ch] = sum_m wx[m] * u[m][ch] and
wsum = sum_m wx[m] * us[m]. The centre exemption (weight A instead of A * F
where the clamped tap is the clamped centre) folds into one term: such a tap
has luma distance 0, so F = f(0) there (1 for edge and flat, 1.2 for
texture), and sum E * (1 - F) * pix = (1 - f(0)) * pix_centre * (sum_n
wye[n]) * (sum_m wxe[m]); zero unless the centre is texture.

Tolerances: ≤1 u8 LSB with a share of differing bytes < 1e-3 against each
of the three (f32 sums in another order; the oracle is float64; the jnp
graph, which compiles per shape and scale, on the first case at every
scale), and a constant 255 alpha with ``opaque_alpha``."""

import numpy as np
import pytest
import torch

from bicubic_interpolation_model_tpu.core.oracle import (
    adaptive_bicubic_oracle)
from bicubic_interpolation_model_tpu.ops import adaptive as jadaptive
from bicubic_interpolation_model_tpu_torch.ops import (
    adaptive_fused as tfused)
from bicubic_interpolation_model_tpu_torch.ops.adaptive import (
    EDGE, FLAT, TEXTURE, _edge_pad, centre_offset, luma_bt709,
    region_classes)

from test_torch_adaptive import all_class_frame


def _factors(k, d):
    """The three modulation laws of the centre class ``k`` at luma distance
    ``d``, as the plain version writes them."""
    return torch.where(
        k == EDGE, torch.clamp(1.0 + d * 0.01, max=1.5),
        torch.where(k == FLAT, torch.clamp(1.0 - d * (1.0 / 30.0), min=0.5),
                    0.8 + 0.4 * torch.exp(d * -0.05)))


def factored_adaptive(img_bhwc, wy, wye, wx, s, opaque_alpha=False):
    """Kernel E's arithmetic in f32, in its order: uint8 [B, H, W, C] ->
    uint8 [B, H*S, W*S, C]."""
    b, h, w, c = img_bhwc.shape
    opaque = opaque_alpha and c == 4
    nc = 3 if opaque else c
    x = img_bhwc.float()
    luma = luma_bt709(x)
    cls = region_classes(luma)
    lp = _edge_pad(luma, 1, 2, 1, 2, -2, -1)           # tap lumas
    xp = _edge_pad(x[..., :nc], 1, 2, 1, 2, 1, 2)      # tap pixels
    lp1 = _edge_pad(luma, 0, 1, 0, 1, -2, -1)          # centre lumas
    cp1 = _edge_pad(cls, 0, 1, 0, 1, -2, -1)           # centre classes
    wyv = wy.float().reshape(h, s, 4)
    wyev = wye.float().reshape(h, s, 4)
    wxv = wx.float()[:4 * s].reshape(s, 4, w)
    wxev = wx.float()[4 * s:].reshape(s, 4, w)
    sye = wyev[..., 0] + wyev[..., 1] + wyev[..., 2] + wyev[..., 3]  # [h, s]
    sxe = wxev[:, 0] + wxev[:, 1] + wxev[:, 2] + wxev[:, 3]          # [s, w]
    out = torch.zeros((b, h, s, w, s, 4), dtype=torch.uint8)
    if opaque:
        out[..., 3] = 255
    groups: dict = {}
    for p in range(s):
        groups.setdefault(centre_offset(p, s), []).append(p)
    for cy, qs in groups.items():
        for cx, ps in groups.items():
            k = cp1[:, cy:cy + h, cx:cx + w]
            cl = lp1[:, cy:cy + h, cx:cx + w]
            f = [[_factors(k, (cl - lp[:, n:n + h, m:m + w]).abs())
                  for m in range(4)] for n in range(4)]
            one_minus_f0 = 1.0 - _factors(k, torch.zeros_like(cl))
            pix_c = xp[:, 1 + cy:1 + cy + h, 1 + cx:1 + cx + w]
            for q in qs:
                u, us = [], []
                for m in range(4):
                    um, usm = 0.0, 0.0
                    for n in range(4):
                        a = wyv[:, q, n, None] * f[n][m]
                        um = um + a[..., None] * xp[:, n:n + h, m:m + w]
                        usm = usm + a
                    u.append(um)
                    us.append(usm)
                for p in ps:
                    acc, wsum = 0.0, 0.0
                    for m in range(4):
                        acc = acc + wxv[p, m][:, None] * u[m]
                        wsum = wsum + wxv[p, m] * us[m]
                    t = (one_minus_f0 * sye[:, q, None]) * sxe[p][None, :]
                    acc = acc + t[..., None] * pix_c
                    wsum = wsum + t
                    v = torch.floor(acc * (1.0 / wsum)[..., None] + 0.5)
                    out[:, :, q, :, p, :nc] = torch.clamp(v, 0, 255).to(
                        torch.uint8)
    return out.reshape(b, h * s, w * s, 4)[..., :c].contiguous()


def _diff(a, b):
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    return int(d.max()), float((d != 0).mean())


# ragged for the kernel's 8 x 32 LR tiles; edge rows and columns clamp
CASES = [("mosaic", 13, 11, 4), ("mosaic", 9, 37, 3), ("step", 10, 12, 4),
         ("lownoise", 7, 34, 3)]


@pytest.mark.parametrize("s", [1, 2, 3, 4, 15])
@pytest.mark.parametrize("name,h,w,c", CASES)
def test_factored_sum_matches_oracle_graph_and_plain(name, h, w, c, s):
    img = all_class_frame(name, h, w, c, seed=h + w + s)
    t = torch.from_numpy(img)[None]
    wts = tfused._weights(h, w, s, -0.5, torch.device("cpu"), None)
    got = factored_adaptive(t, *wts, s)[0].numpy()
    assert got.shape == (h * s, w * s, c)
    refs = [adaptive_bicubic_oracle(img, s),
            tfused.adaptive_resize_reference(t, *wts, s)[0].numpy()]
    if (name, h, w, c) == CASES[0]:     # the graph compiles per shape
        refs.append(np.asarray(jadaptive.adaptive_resize(img, s, impl="jnp")))
    for ref in refs:
        mx, share = _diff(got, ref)
        assert mx <= 1 and share < 1e-3, (mx, share)
    if c == 4:
        opq = img.copy()
        opq[..., 3] = 255
        to = torch.from_numpy(opq)[None]
        got_o = factored_adaptive(to, *wts, s, opaque_alpha=True)[0].numpy()
        assert (got_o[..., 3] == 255).all()
        mx, share = _diff(got_o, tfused.adaptive_resize_reference(
            to, *wts, s, opaque_alpha=True)[0].numpy())
        assert mx <= 1 and share < 1e-3
        assert _diff(got_o, adaptive_bicubic_oracle(opq, s))[0] <= 1


def test_cases_reach_every_class_and_the_exemption_term():
    """The cases above reach all three laws, and dropping the exemption
    term (weight A * F at the centre) moves texture pixels: the term is
    not a no-op on these frames."""
    seen = set()
    for name, h, w, c in CASES:
        img = torch.from_numpy(all_class_frame(name, h, w, c))
        seen |= set(region_classes(luma_bt709(img.float())).unique().tolist())
    assert seen == {TEXTURE, FLAT, EDGE}
    img = torch.from_numpy(all_class_frame("mosaic", 13, 11, 4))[None]
    wts = tfused._weights(13, 11, 4, -0.5, torch.device("cpu"), None)
    no_exemption = (wts[0], torch.zeros_like(wts[1]),
                    torch.cat([wts[2][:16], torch.zeros_like(wts[2][16:])]))
    assert _diff(factored_adaptive(img, *wts, 4),
                 factored_adaptive(img, *no_exemption, 4))[0] > 1
