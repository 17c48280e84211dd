"""The ops this slice adds, on the CPU (their plain versions), against the
JAX package's Pallas kernels in interpret mode: multi-head attention forward
and its autograd gradient (``_attention_pallas`` and ``jax.grad`` of it, as
tests/test_ops.py runs them), and the packed top-k extraction
(``cosine_topk_pallas(..., packed=True)``). The CUDA kernels themselves are
held against the plain versions on the GPU in tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.ops.attention import (
    _attention_pallas,
    _attention_pallas_bwd_impl,
)
from instacart_next_order_recommendation_tpu.ops.topk import (
    cosine_topk_pallas,
    cosine_topk_reference as jax_topk_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops import (
    cosine_topk,
    multi_head_attention,
    multi_head_attention_backward,
    multi_head_attention_backward_reference,
    multi_head_attention_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops.topk import (
    cosine_topk_packed_reference,
    quantized_keys,
    quantized_scores,
)

# One bf16 ulp relative to a tensor's largest magnitude is at most 2^-7
# anywhere in it; another summation order can flip one rounding.
BF16_REL = 2.0**-7


def _qkv_mask(rng, batch, heads, seq, dim, all_pad_row=True):
    q, k, v = (rng.standard_normal((batch, heads, seq, dim)).astype(np.float32) for _ in range(3))
    lengths = rng.integers(1, seq + 1, size=batch)
    if all_pad_row:
        lengths[-1] = 0  # attends uniformly over its S keys, in both packages
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, mask


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [16, 40, 512])
@pytest.mark.parametrize("dim", [32, 64])
def test_forward_and_gradient_match_jax_pallas(dim, seq, dtype):
    rng = np.random.default_rng(dim + seq)
    batch, heads = (3, 2) if seq < 512 else (2, 1)
    q, k, v, mask = _qkv_mask(rng, batch, heads, seq, dim)
    g = rng.standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / dim**0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jmask = jnp.asarray(mask)

    def jax_loss(a, b, c):
        out = _attention_pallas(a, b, c, jmask, scale, True)
        return jnp.sum(out.astype(jnp.float32) * g)

    ref = _attention_pallas(jq, jk, jv, jmask, scale, True)
    ref_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    out = multi_head_attention(tq, tk, tv, torch.from_numpy(mask), scale)
    (out.to(torch.float32) * torch.from_numpy(g)).sum().backward()
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    assert multi_head_attention.launches == 0  # the CPU never counts a launch

    if dtype == "float32":
        # f32 sums in another order only.
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-6)
        for t, r in zip((tq, tk, tv), ref_grads):
            np.testing.assert_allclose(_np(t.grad), _np(r), atol=2e-5, rtol=1e-5)
    else:
        # bf16 operands and outputs: one rounding may flip (BF16_REL).
        for got, want in [(out, ref), *zip((tq.grad, tk.grad, tv.grad), ref_grads)]:
            err = np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max()
            assert err <= BF16_REL, err


def test_all_pad_row_attends_uniformly_over_its_keys():
    rng = np.random.default_rng(1)
    q, k, v, mask = _qkv_mask(rng, 2, 2, 40, 32)
    out = multi_head_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, mask)), 0.2)
    uniform = np.broadcast_to(v[-1].mean(axis=1, keepdims=True), v[-1].shape)
    np.testing.assert_allclose(out[-1].numpy(), uniform, atol=1e-5)


def test_masked_keys_do_not_leak():
    rng = np.random.default_rng(2)
    q, k, v, mask = _qkv_mask(rng, 3, 2, 40, 64, all_pad_row=False)
    a = multi_head_attention_reference(*(torch.from_numpy(x) for x in (q, k, v, mask)), 0.125)
    k2, v2 = k.copy(), v.copy()
    for row in range(3):
        k2[row, :, mask[row] == 0, :] = 777.0
        v2[row, :, mask[row] == 0, :] = -555.0
    b = multi_head_attention_reference(*(torch.from_numpy(x) for x in (q, k2, v2, mask)), 0.125)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_cpu_backward_is_the_plain_version():
    rng = np.random.default_rng(3)
    q, k, v, mask = _qkv_mask(rng, 2, 3, 24, 32)
    do = rng.standard_normal(q.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v, mask, do)]
    got = multi_head_attention_backward(*args, 0.25)
    want = multi_head_attention_backward_reference(*args, 0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert multi_head_attention_backward.launches == 0


# ------------------------------------------- the CUDA backward's arithmetic


def _bf16_parts(x, split=True):
    """x as the bf16 terms the CUDA backward feeds to its products: hi =
    bf16(x) and lo = bf16(x - hi), or hi alone."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return (hi, (x - hi).to(torch.bfloat16).to(torch.float32)) if split else (hi,)


def _k7_arithmetic(q, k, v, mask, do, scale, split=True, tile=64):
    """A model of ``csrc/attention.cu``'s backward on f32 tensors. Per query
    row: the online max m, sum l and u = sum exp(x - m) dP over 64-key tiles,
    so Dr = u / l; then P = exp(x - m) * (1 / l) and dS = P (dP - Dr). P and
    dS enter their products as bf16 terms (``_bf16_parts``), every product
    summed in f32. Keys past S take the kernel's -3e38 bias."""
    s = q.shape[2]
    pad = -s % tile
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    bias = torch.nn.functional.pad((1.0 - mask.to(torch.float32)) * -1e9, (0, pad), value=-3e38)
    x = (q @ kp.transpose(-1, -2)) * scale + bias[:, None, None, :]
    dp = do @ vp.transpose(-1, -2)
    m = torch.full(x.shape[:-1], -3e38)
    l, u = torch.zeros_like(m), torch.zeros_like(m)
    for t0 in range(0, s + pad, tile):
        xt, dpt = x[..., t0 : t0 + tile], dp[..., t0 : t0 + tile]
        mn = torch.maximum(m, xt.amax(dim=-1))
        e, rescale = torch.exp(xt - mn[..., None]), torch.exp(m - mn)
        l = l * rescale + e.sum(dim=-1)
        u = u * rescale + (e * dpt).sum(dim=-1)
        m = mn
    p = torch.exp(x - m[..., None]) * (1.0 / l)[..., None]
    ds = p * (dp - (u / l)[..., None])
    dq = sum(part @ kp for part in _bf16_parts(ds, split)) * scale
    dk = sum(part.transpose(-1, -2) @ q for part in _bf16_parts(ds, split)) * scale
    dv = sum(part.transpose(-1, -2) @ do for part in _bf16_parts(p, split))
    return dq, dk[..., :s, :], dv[..., :s, :]


# The split model against f32 backwards, relative to each gradient's largest
# magnitude: hi + lo keeps P and dS to about 2^-17, and the sums run in
# another order.
K7_SPLIT_REL = 1e-4


@pytest.mark.parametrize("seq", [40, 192, 256])
@pytest.mark.parametrize("dim", [32, 64])
def test_k7_split_arithmetic_matches_jax_backward(dim, seq):
    rng = np.random.default_rng(100 + dim + seq)
    q, k, v, mask = _qkv_mask(rng, 3, 2, seq, dim)  # the last row all pad
    do = rng.standard_normal(q.shape).astype(np.float32)
    # bf16 values held in f32: the kernel's operands, and no final rounding
    # of the gradients to hide the error.
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).to(torch.float32) for a in (q, k, v, do))
    scale = 1.0 / dim**0.5
    jax_grads = _attention_pallas_bwd_impl(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(mask), jnp.asarray(do.numpy()),
        scale, True,
    )
    tmask = torch.from_numpy(mask)
    plain = multi_head_attention_backward_reference(q, k, v, tmask, do, scale)
    model = _k7_arithmetic(q, k, v, tmask, do, scale)
    single = _k7_arithmetic(q, k, v, tmask, do, scale, split=False)
    single_err = 0.0
    names = ("dq", "dk", "dv")
    for name, got, want_jax, want_plain, one in zip(names, model, jax_grads, plain, single):
        assert got.dtype == torch.float32 and tuple(got.shape) == q.shape, name
        for want in (_np(want_jax), _np(want_plain)):
            err = np.abs(_np(got) - want).max() / np.abs(want).max()
            assert err <= K7_SPLIT_REL, (name, err)
        want = _np(want_jax)
        single_err = max(single_err, np.abs(_np(one) - want).max() / np.abs(want).max())
    # One bf16 rounding of P and dS would not do: the split is what holds the
    # kernel to JAX's f32 backward.
    assert single_err > K7_SPLIT_REL, single_err


# ------------------------------------------------------------- packed top-k


def _grid_inputs(rng, b, n, d):
    """Small-integer grid values: every dot product is exact in f32, so any
    summation order gives the same scores, and ties are exact."""
    c = (rng.integers(-8, 9, size=(n, d)) / 16).astype(np.float32)
    q = (rng.integers(-8, 9, size=(b, d)) / 16).astype(np.float32)
    c[200:210] = c[7]  # exact ties across blocks
    c[8] = c[7]        # and within one
    q[0] = c[7]
    return q, c


@pytest.mark.parametrize(
    "b,n,k,n_valid,masked",
    [(4, 600, 10, None, False), (3, 700, 16, 650, True), (2, 300, 40, 280, False)],
)
def test_packed_plain_version_identical_to_jax_packed_kernel(b, n, k, n_valid, masked):
    rng = np.random.default_rng(n + k)
    q, c = _grid_inputs(rng, b, n, 32)
    mask = (rng.random(n) < 0.6).astype(np.int32) if masked else None
    if masked:
        mask[[7, 8, 200, 205]] = 1
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    s, i = cosine_topk_packed_reference(torch.from_numpy(q), torch.from_numpy(c), k, n_valid, tmask)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for block_n in (128, 256):
        ref_s, ref_i = cosine_topk_pallas(
            jnp.asarray(q), jnp.asarray(c), k, block_n=block_n, interpret=True,
            n_valid=n_valid, candidate_mask=jmask, packed=True,
        )
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    # The entry point on the CPU is the plain version.
    s2, i2 = cosine_topk(torch.from_numpy(q), torch.from_numpy(c), k, n_valid, tmask, packed=True)
    assert torch.equal(s2, s) and torch.equal(i2, i)
    # Quantized ties (row 0's best key is shared by c[7], c[8], c[200:210]
    # and rows within 20 bits of them) go to the lowest index.
    same = s[:, 1:] == s[:, :-1]
    assert same.any() and (i[:, 1:] > i[:, :-1])[same].all()
    if not masked:
        assert i[0, :2].tolist() == [7, 8]


def test_packed_keys_round_trip_and_order():
    x = torch.tensor([-1e30, -3.5, -1e-3, -0.0, 0.0, 1e-3, 0.25, 0.2501, 0.9], dtype=torch.float32)
    keys = quantized_keys(x)
    assert (keys[1:] >= keys[:-1]).all()  # order-preserving, signed int32
    back = quantized_scores(keys)
    rel = ((back - x).abs() / x.abs().clamp_min(1e-30))[x != 0]
    assert (rel <= 2.0**-11).all()  # 11 mantissa bits kept
    assert quantized_keys(back).equal(keys)
    # 0.25 and 0.2501 share a key at 20 bits: a quantization tie.
    assert keys[6] == keys[7]


def test_packed_random_scores_agree_with_exact_up_to_quantization():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((6, 48)).astype(np.float32)
    c = rng.standard_normal((2000, 48)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    s_p, i_p = cosine_topk(torch.from_numpy(q), torch.from_numpy(c), 10, packed=True)
    s_e, i_e = jax_topk_reference(jnp.asarray(q), jnp.asarray(c), 10)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_e), atol=5e-4)
    scores = q @ c.T
    for row in range(q.shape[0]):
        for a, b in zip(i_p[row].tolist(), np.asarray(i_e)[row].tolist()):
            # A swap is a tie within the 20-bit quantization step.
            assert abs(scores[row, a] - scores[row, b]) <= 2.0**-10 * abs(scores[row, b])
    # k above the block size takes the exact route, packed or not.
    s_big, i_big = cosine_topk(torch.from_numpy(q), torch.from_numpy(c), 300, packed=True)
    ref_s, ref_i = jax_topk_reference(jnp.asarray(q), jnp.asarray(c), 300)
    np.testing.assert_array_equal(i_big.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(s_big.numpy(), np.asarray(ref_s), atol=1e-6)
