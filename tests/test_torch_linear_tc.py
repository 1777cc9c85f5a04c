"""The linear kernel of the port (``csrc/linear_tc.cu``, wrapper
``ops/linear_tc.linear_tc``): the plain version and the wrapper's contract
on the CPU, the packed weights' layout against the kernel's fragment map,
an emulation of its 3xTF32 arithmetic, and the kernel on the card against
float64 at SwinIR-M's four linears on the 176,128 tokens of its cell.

This file imports nothing of JAX, so it also runs on a machine with a card
and no JAX: ``python -m pytest --noconftest -m cuda -s
tests/test_torch_linear_tc.py``. Tests marked ``cuda`` skip without a card
(a CUDA kernel has no CPU mode).

Tolerances, each as a share of the largest output in float64:

- the plain version in float32 against float64: 1e-5 (f32 products and
  sums over K <= 360 terms, ~1e-7 relative each);
- the CPU emulation of the kernel's 3xTF32 products (round-to-nearest
  split, a fresh sum a stage of 32 k added in f32): within 2x a plain f32
  product's error on the same inputs plus 2^-24; one TF32 pass (hi * hi
  only) is off by more than 20x that;
- on the card, the kernel: 2e-5 (3xTF32 leaves ~1e-6; one TF32 pass
  ~1e-3), with cuBLAS f32's error printed beside it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bicubic_interpolation_model_tpu_torch.ops import linear_tc as lt

#: the kernel's largest error against float64 over the largest output
KERNEL_TOL = 2e-5
#: SwinIR-M's four linears of a block: (name, K, N, epilogue)
PUBLISHED = [("qkv", 180, 540, "none"), ("proj", 180, 180, "residual"),
             ("fc1", 180, 360, "gelu"), ("fc2", 360, 180, "residual")]
#: tokens of the cell's grid (339x510 padded to 344x512)
TOKENS = 344 * 512


def _case(m, k, n, epilogue, seed, device="cpu"):
    """x [m, k] at LayerNorm's scale, a Dense kernel of std sqrt(2 / k),
    a bias of std 0.1, and for the residual epilogue a residual [m, n];
    drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x = t(rng.normal(0, 1, (m, k)))
    kernel = t(rng.normal(0, np.sqrt(2 / k), (k, n)))
    bias = t(rng.normal(0, 0.1, n))
    res = t(rng.normal(0, 1, (m, n))) if epilogue == "residual" else None
    return x, kernel, bias, res


def _float64(x, kernel, bias, epilogue, res):
    y = x.double() @ kernel.double() + bias.double()
    if epilogue == "gelu":
        return F.gelu(y)
    if epilogue == "residual":
        return res.double() + y
    return y


def _share(y, want):
    return float((y.double() - want).abs().max() / want.abs().max())


# -- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(37, 180, 540), (21, 360, 180),
                                   (9, 12, 10)])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual",
                                      "residual_aliased"])
def test_plain_version_matches_float64(m, k, n, epilogue):
    aliased = epilogue == "residual_aliased"
    epi = "residual" if aliased else epilogue
    x, kernel, bias, res = _case(m, k, n, epi, seed=m + k + n)
    want = _float64(x, kernel, bias, epi, res)
    launches = lt.linear_tc.launches
    got = lt.linear_reference(x, kernel, bias, epi, residual=res,
                              out=res if aliased else None)
    assert lt.linear_tc.launches == launches
    assert got.shape == (m, n) and got.dtype == torch.float32
    if aliased:
        assert got.data_ptr() == res.data_ptr()
    assert _share(got, want) <= 1e-5


def test_plain_version_gelu_is_the_exact_form():
    x = torch.linspace(-4, 4, 64)[:, None].repeat(1, 4)
    y = lt.linear_reference(x, torch.eye(4), torch.zeros(4), "gelu")
    exact = 0.5 * x.double() * (1 + torch.erf(x.double() / 2 ** 0.5))
    assert float((y.double() - exact).abs().max()) <= 1e-6
    tanh = F.gelu(x, approximate="tanh")
    assert float((tanh.double() - exact).abs().max()) > 1e-4


def test_plain_version_differentiates():
    x, kernel, bias, res = _case(5, 8, 6, "residual", seed=2)
    kernel.requires_grad_(True)
    lt.linear_reference(x, kernel, bias, "residual",
                        residual=res).sum().backward()
    assert kernel.grad is not None and float(kernel.grad.abs().max()) > 0


def _bad(case):
    x, kernel, bias, res = _case(6, 8, 10, "residual", seed=1)
    kw = {"epilogue": "residual", "residual": res}
    if case == "dtype":
        x, kernel, bias = x.double(), kernel.double(), bias.double()
        kw["residual"] = res.double()
    elif case == "kernel_k":
        kernel = torch.zeros((12, 10))
    elif case == "kernel_dtype":
        kernel = kernel.double()
    elif case == "x_dims":
        x = x[None]
    elif case == "k_not_multiple_of_4":
        x, kernel = torch.zeros((6, 6)), torch.zeros((6, 10))
    elif case == "n_odd":
        kernel, bias = torch.zeros((8, 9)), torch.zeros(9)
        kw["residual"] = torch.zeros((6, 9))
    elif case == "bias":
        bias = torch.zeros(11)
    elif case == "x_strided":
        x = torch.zeros((8, 6)).t()
    elif case == "residual_shape":
        kw["residual"] = torch.zeros((6, 12))
    elif case == "residual_missing":
        kw["residual"] = None
    elif case == "residual_with_gelu":
        kw["epilogue"] = "gelu"
    elif case == "out_without_residual":
        kw = {"epilogue": "none", "out": torch.zeros((6, 10))}
    elif case == "epilogue":
        kw["epilogue"] = "relu"
    return x, kernel, bias, kw


@pytest.mark.parametrize("case", [
    "cpu", "dtype", "kernel_k", "kernel_dtype", "x_dims",
    "k_not_multiple_of_4", "n_odd", "bias", "x_strided", "residual_shape",
    "residual_missing", "residual_with_gelu", "out_without_residual",
    "epilogue"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The wrapper launches for float32 on the card alone: a CPU tensor, a
    float64 one, mismatched or misshapen operands raise before any launch
    (the plain version serves them, chosen by the caller)."""
    x, kernel, bias, kw = _bad(case)
    launches = lt.linear_tc.launches
    with pytest.raises(ValueError, match="linear_tc"):
        lt.linear_tc(x, kernel, bias, **kw)
    assert lt.linear_tc.launches == launches


def test_wrapper_refuses_grad_on_tensors():
    x, kernel, bias, _ = _case(4, 8, 6, "none", seed=3)
    kernel.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        lt.linear_tc(x, kernel, bias)


def test_serves_float32_on_the_card_alone():
    assert not lt.serves(torch.zeros(1))
    assert not lt.serves(torch.zeros(1).double())
    assert not lt.serves(torch.zeros(1, device="meta"))


def test_k_order_reads_each_column_of_a_stage_once():
    order = lt.k_order()
    assert sorted(order.tolist()) == list(range(lt.KC))
    # a thread's fragments of the four steps: columns 4 t .. 4 t + 3 and
    # 16 + 4 t .. 16 + 4 t + 3 (two 16-byte loads); step s, column t
    # (a[0], a[1]) and t + 4 (a[2], a[3])
    for t in range(4):
        cols = {int(order[8 * s + kk]) for s in range(4)
                for kk in (t, t + 4)}
        assert cols == set(range(4 * t, 4 * t + 4)) | set(
            range(16 + 4 * t, 20 + 4 * t))


@pytest.mark.parametrize("k,n", [(180, 540), (360, 180), (180, 360),
                                 (20, 22)])
def test_packed_weights_are_the_kernels_split_core_matrices(k, n):
    """Per stage of 32 k, k8 step s and part (hi, lo), B as wgmma reads it
    without swizzle: fragment column kk of column n at float 64 (n // 8) +
    32 (kk // 4) + 4 (n % 8) + kk % 4, the weight of row 32 stage +
    k_order[8 s + kk] (zero past K and N); hi rounded to the nearest TF32
    value and lo the rest rounded the same way."""
    g = torch.Generator().manual_seed(k + n)
    w = torch.randn((k, n), generator=g)
    bn = lt.TILE_COLUMNS
    kp, np_ = -(-k // 32) * 32, -(-n // bn) * bn
    p = lt.pack(w).reshape(kp // 32, 4, 2, 8 * np_)
    wp = torch.zeros((kp, np_))
    wp[:k, :n] = w
    hi = lt.tf32_rn(wp)
    lo = lt.tf32_rn(wp - hi)
    assert float((hi + lo - wp).abs().max()) <= 2.0 ** -21 * float(
        wp.abs().max())
    kk, nn = np.meshgrid(np.arange(8), np.arange(np_), indexing="ij")
    at = torch.from_numpy(64 * (nn // 8) + 32 * (kk // 4) + 4 * (nn % 8)
                          + kk % 4)
    order = lt.k_order().reshape(4, 8)
    for c in range(kp // 32):
        for s in range(4):
            rows = 32 * c + order[s]
            for part, want in enumerate((hi, lo)):
                assert torch.equal(p[c, s, part][at], want[rows])


def test_packed_weights_are_kept_until_the_kernel_changes():
    w = torch.randn((8, 10))
    first = lt.packed_weights(w)
    assert first.numel() == 32 * 2 * lt.TILE_COLUMNS
    assert lt.packed_weights(w) is first
    with torch.no_grad():
        w.mul_(2)
    again = lt.packed_weights(w)
    assert again is not first and torch.equal(again, 2 * first)


def _split(a):
    hi = lt.tf32_rn(a)
    return hi, lt.tf32_rn(a - hi)


def _emulate(x, w, passes):
    """The kernel's sum: per stage of 32 k, the products ``passes`` of the
    split operands over its k8 steps summed in float64 (the tensor cores'
    sum, here without its truncation), then added to an f32 running sum."""
    (m, k), n = x.shape, w.shape[1]
    xh, xl = _split(x)
    wh, wl = _split(w)
    terms = {"hh": (xh, wh), "lh": (xl, wh), "hl": (xh, wl)}
    acc = torch.zeros((m, n))
    for c in range(0, k, lt.KC):
        stage = torch.zeros((m, n), dtype=torch.float64)
        for name in passes:
            a, b = terms[name]
            stage += a[:, c:c + lt.KC].double() @ b[c:c + lt.KC].double()
        acc = acc + stage.float()
    return acc


@pytest.mark.parametrize("k", [180, 360])
def test_3xtf32_emulation_is_as_accurate_as_an_f32_product(k):
    x, w, _, _ = _case(64, k, 96, "none", seed=k)
    exact = x.double() @ w.double()
    err = lambda y: _share(y, exact)
    f32 = err(x @ w)
    three = err(_emulate(x, w, ("lh", "hl", "hh")))
    one = err(_emulate(x, w, ("hh",)))
    print(f"K {k}: 3xTF32 {three:.3g}, f32 {f32:.3g}, one TF32 pass "
          f"{one:.3g} of the largest output")
    assert three <= 2 * f32 + 2.0 ** -24
    assert one > 20 * (f32 + 2.0 ** -24)


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _cublas(x, kernel, bias, epilogue, res):
    """cuBLAS f32 (TF32 off) and PyTorch's epilogue: the plain version."""
    return lt.linear_reference(x, kernel, bias, epilogue, residual=res)


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,n,own", PUBLISHED)
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual"])
def test_kernel_matches_float64_at_the_published_shapes_on_card(
        card, name, k, n, own, epilogue):
    x, kernel, bias, res = _case(TOKENS, k, n, epilogue, seed=k + n,
                                 device=card)
    launches = lt.linear_tc.launches
    got = lt.linear_tc(x, kernel, bias, epilogue, residual=res)
    torch.cuda.synchronize()
    assert lt.linear_tc.launches == launches + 1
    want = _float64(x, kernel, bias, epilogue, res)
    ours = _share(got, want)
    cublas = _share(_cublas(x, kernel, bias, epilogue, res), want)
    print(f"{name} {k} -> {n} ({own} in SwinIR), {epilogue}: kernel "
          f"{ours:.3e}, cuBLAS f32 {cublas:.3e} of the largest output")
    assert ours <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4, 2), (77, 20, 22), (129, 44, 10),
                                   (300, 180, 540), (513, 360, 180),
                                   (1000, 12, 72)])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual"])
def test_kernel_at_ragged_shapes_on_card(card, m, k, n, epilogue):
    """Rows past a tile, K past a stage (and no multiple of 8), N past a
    tile: every element stored once, nothing beyond."""
    x, kernel, bias, res = _case(m, k, n, epilogue, seed=m + k + n,
                                 device=card)
    want = _float64(x, kernel, bias, epilogue, res)
    buf = out = None
    if res is not None:
        buf = torch.full((m + 1, n), 7.0, device=card)
        buf[:m] = res
        out = buf[:m]
    got = lt.linear_tc(x, kernel, bias, epilogue, residual=out, out=out)
    torch.cuda.synchronize()
    assert _share(got, want) <= KERNEL_TOL
    if buf is not None:
        assert got.data_ptr() == buf.data_ptr()
        assert bool((buf[m:] == 7.0).all())


@pytest.mark.cuda
def test_output_may_be_the_residual_on_card(card):
    x, kernel, bias, res = _case(TOKENS, 360, 180, "residual", seed=9,
                                 device=card)
    want = _float64(x, kernel, bias, "residual", res)
    got = lt.linear_tc(x, kernel, bias, "residual", residual=res, out=res)
    torch.cuda.synchronize()
    assert got.data_ptr() == res.data_ptr()
    assert _share(got, want) <= KERNEL_TOL
