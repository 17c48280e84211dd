"""The port's ops on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles. The CUDA
kernels themselves are held against the plain versions on the GPU in
tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.ops import fused_layer as jax_fused
from instacart_next_order_recommendation_tpu.ops.pool_norm import (
    masked_mean_pool_l2norm_pallas,
    masked_mean_pool_l2norm_reference as jax_pool_reference,
)
from instacart_next_order_recommendation_tpu.ops.topk import (
    cosine_topk_pallas,
    cosine_topk_reference as jax_topk_reference,
)
from instacart_next_order_recommendation_tpu_torch.ops import (
    cosine_topk,
    fused_encoder_layer,
    masked_mean_pool_l2norm,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    fused_encoder_layer_reference,
)

HIDDEN, INTER, HEADS = 128, 256, 4
SCALE = 1.0 / (HIDDEN // HEADS) ** 0.5
EPS = 1e-12


def _layer_np(rng, hidden=HIDDEN, inter=INTER):
    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "q_w": w(hidden, hidden), "q_b": w(hidden),
        "k_w": w(hidden, hidden), "k_b": w(hidden),
        "v_w": w(hidden, hidden), "v_b": w(hidden),
        "o_w": w(hidden, hidden), "o_b": w(hidden),
        "attn_ln_scale": (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32),
        "attn_ln_bias": w(hidden),
        "ffn_w1": w(hidden, inter), "ffn_b1": w(inter),
        "ffn_w2": w(inter, hidden), "ffn_b2": w(hidden),
        "ffn_ln_scale": (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32),
        "ffn_ln_bias": w(hidden),
    }


def _mask_np(rng, batch, seq, all_pad_row=False):
    lengths = rng.integers(seq // 4, seq + 1, size=batch)
    if all_pad_row:
        lengths[-1] = 0
    return (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)


def _jax_layer_args(x_np, mask_np, layer, cdt):
    """Operands of the JAX ``_call``/``_oracle``, built as tests/test_ops.py does."""
    seq = x_np.shape[1]
    x = jnp.asarray(x_np, cdt)
    skv = -(-seq // 128) * 128
    bias = ((1.0 - mask_np.astype(np.float32)) * -1e9)[:, None, :]
    bias = jnp.asarray(np.pad(bias, ((0, 0), (0, 0), (0, skv - seq)), constant_values=-1e9))
    L = {k: jnp.asarray(v) for k, v in layer.items()}
    qkv_w = jnp.concatenate([L["q_w"], L["k_w"], L["v_w"]], axis=1).astype(cdt)
    qkv_b = jnp.concatenate([L["q_b"], L["k_b"], L["v_b"]]).reshape(1, -1).astype(cdt)
    weights = (
        qkv_w, qkv_b,
        L["o_w"].astype(cdt), L["o_b"].reshape(1, -1).astype(cdt),
        L["attn_ln_scale"].reshape(1, -1), L["attn_ln_bias"].reshape(1, -1),
        L["ffn_w1"].astype(cdt), L["ffn_b1"].reshape(1, -1).astype(cdt),
        L["ffn_w2"].astype(cdt), L["ffn_b2"].reshape(1, -1).astype(cdt),
        L["ffn_ln_scale"].reshape(1, -1), L["ffn_ln_bias"].reshape(1, -1),
    )
    return x, bias, weights


def _port_layer(x_np, mask_np, layer, dtype):
    x = torch.from_numpy(x_np).to(dtype)
    mask = torch.from_numpy(mask_np)
    L = {k: torch.from_numpy(v) for k, v in layer.items()}
    return fused_encoder_layer(x, mask, L, num_heads=HEADS, scale=SCALE, eps=EPS)


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


class TestFusedLayer:
    @pytest.mark.parametrize(
        "dtype,atol,rtol,batch,seq,all_pad",
        [
            ("float32", 1e-4, 0.0, 2, 64, False),
            ("float32", 1e-4, 0.0, 3, 32, True),
            ("bfloat16", 2e-2, 1e-2, 3, 32, True),
        ],
    )
    def test_matches_jax_kernel_and_oracle(self, dtype, atol, rtol, batch, seq, all_pad):
        # f32: the only systematic gap is the JAX kernel's A&S erf (< 2e-6)
        # against torch.erf. bf16: another summation order can flip the
        # rounding of a stored activation (x1 feeds both the FFN and the
        # second residual), so an output may move by two bf16 ulps: rtol 1e-2
        # is 2.5 ulps.
        rng = np.random.default_rng(0)
        layer = _layer_np(rng)
        x_np = (0.5 * rng.standard_normal((batch, seq, HIDDEN))).astype(np.float32)
        mask_np = _mask_np(rng, batch, seq, all_pad_row=all_pad)
        cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "float32" else torch.bfloat16
        x, bias, weights = _jax_layer_args(x_np, mask_np, layer, cdt)
        kernel = jax_fused._call(
            x, bias, *weights, num_heads=HEADS, scale=SCALE, eps=EPS, interpret=True
        )
        oracle = jax_fused._oracle(
            x, bias, None, None, *weights, num_heads=HEADS, scale=SCALE, eps=EPS
        )
        port = _port_layer(x_np, mask_np, layer, tdt)
        assert port.dtype == tdt and tuple(port.shape) == (batch, seq, HIDDEN)
        assert np.isfinite(_as_np(port)).all()
        np.testing.assert_allclose(_as_np(port), _as_np(oracle), atol=atol, rtol=rtol)
        # An all-pad row attends over the Pallas kernel's 128-padded K/V (zero
        # rows included) but over S keys in the oracle and the port, so the
        # JAX kernel is held only on rows with a real token.
        real = mask_np.any(axis=1)
        np.testing.assert_allclose(
            _as_np(port)[real], _as_np(kernel)[real], atol=atol, rtol=rtol
        )

    def test_all_pad_row_differs_between_jax_kernel_and_oracle(self):
        """Pins the JAX package's own disagreement (kernel vs oracle) on an
        all-pad row at S % 128 != 0; the port follows the oracle."""
        rng = np.random.default_rng(0)
        layer = _layer_np(rng)
        x_np = (0.5 * rng.standard_normal((2, 32, HIDDEN))).astype(np.float32)
        mask_np = _mask_np(rng, 2, 32, all_pad_row=True)
        x, bias, weights = _jax_layer_args(x_np, mask_np, layer, jnp.float32)
        kernel = jax_fused._call(
            x, bias, *weights, num_heads=HEADS, scale=SCALE, eps=EPS, interpret=True
        )
        oracle = jax_fused._oracle(
            x, bias, None, None, *weights, num_heads=HEADS, scale=SCALE, eps=EPS
        )
        port = _port_layer(x_np, mask_np, layer, torch.float32).numpy()
        assert np.abs(_as_np(kernel)[1] - _as_np(oracle)[1]).max() > 1e-2
        np.testing.assert_allclose(port[1], _as_np(oracle)[1], atol=1e-4)

    def test_masked_positions_do_not_leak(self):
        """Garbage at padded positions must not change real-token output."""
        rng = np.random.default_rng(1)
        layer = _layer_np(rng)
        batch, seq, n_real = 2, 64, 37
        x_np = (0.5 * rng.standard_normal((batch, seq, HIDDEN))).astype(np.float32)
        mask_np = np.repeat((np.arange(seq) < n_real)[None].astype(np.int32), batch, 0)
        a = _port_layer(x_np, mask_np, layer, torch.float32)
        x2 = x_np.copy()
        x2[:, n_real:, :] = 777.0
        b = _port_layer(x2, mask_np, layer, torch.float32)
        np.testing.assert_allclose(a[:, :n_real].numpy(), b[:, :n_real].numpy(), atol=1e-5)

    def test_cpu_wrapper_is_the_plain_version(self):
        rng = np.random.default_rng(2)
        layer = {k: torch.from_numpy(v) for k, v in _layer_np(rng).items()}
        x = torch.from_numpy((0.5 * rng.standard_normal((2, 16, HIDDEN))).astype(np.float32))
        mask = torch.from_numpy(_mask_np(rng, 2, 16))
        before = fused_encoder_layer.launches
        out = fused_encoder_layer(x, mask, layer, num_heads=HEADS, scale=SCALE, eps=EPS)
        ref = fused_encoder_layer_reference(x, mask, layer, num_heads=HEADS, scale=SCALE, eps=EPS)
        assert torch.equal(out, ref)
        assert fused_encoder_layer.launches == before  # the CPU never counts a launch


class TestPoolNorm:
    @pytest.mark.parametrize("batch,seq,all_pad", [(3, 16, False), (4, 48, True)])
    def test_matches_jax(self, batch, seq, all_pad):
        rng = np.random.default_rng(3)
        hidden = rng.standard_normal((batch, seq, HIDDEN)).astype(np.float32)
        mask = _mask_np(rng, batch, seq, all_pad_row=all_pad)
        port = masked_mean_pool_l2norm(torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
        pallas = masked_mean_pool_l2norm_pallas(
            jnp.asarray(hidden), jnp.asarray(mask), interpret=True
        )
        ref = jax_pool_reference(jnp.asarray(hidden), jnp.asarray(mask))
        np.testing.assert_allclose(port, np.asarray(pallas), atol=1e-6)
        np.testing.assert_allclose(port, np.asarray(ref), atol=1e-6)
        assert port.dtype == np.float32 and np.isfinite(port).all()


def _topk_inputs(rng, b, n, d):
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return q, c


def _port_topk(q, c, k, **kw):
    kw = {k_: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k_, v in kw.items()}
    s, i = cosine_topk(torch.from_numpy(q), torch.from_numpy(c), k, **kw)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy()


class TestTopK:
    @pytest.mark.parametrize(
        "b,n,k,n_valid",
        [(3, 300, 7, None), (2, 500, 16, 250), (2, 300, 200, None)],  # last: k > block size
    )
    def test_matches_jax(self, b, n, k, n_valid):
        rng = np.random.default_rng(4)
        q, c = _topk_inputs(rng, b, n, 32)
        s, i = _port_topk(q, c, k, n_valid=n_valid)
        for ref_s, ref_i in (
            jax_topk_reference(jnp.asarray(q), jnp.asarray(c), k, n_valid=n_valid),
            cosine_topk_pallas(
                jnp.asarray(q), jnp.asarray(c), k, block_n=128, interpret=True, n_valid=n_valid
            ),
        ):
            np.testing.assert_array_equal(i, np.asarray(ref_i))
            np.testing.assert_allclose(s, np.asarray(ref_s), atol=1e-6)
        if n_valid is not None:
            assert (i < n_valid).all()

    def test_tie_break_lowest_index(self):
        q = np.ones((1, 4), np.float32)
        c = np.concatenate([np.ones((5, 4)), np.zeros((3, 4))]).astype(np.float32)
        _, i = _port_topk(q, c, 3)
        np.testing.assert_array_equal(i[0], [0, 1, 2])
        _, ref_i = cosine_topk_pallas(jnp.asarray(q), jnp.asarray(c), 3, block_n=128, interpret=True)
        np.testing.assert_array_equal(i, np.asarray(ref_i))

    def test_candidate_mask_fewer_eligible_than_k(self):
        rng = np.random.default_rng(5)
        q, c = _topk_inputs(rng, 3, 300, 32)
        mask = np.zeros(300, np.int32)
        mask[[3, 77, 150, 299]] = 1
        k = 9
        s, i = _port_topk(q, c, k, candidate_mask=mask)
        ref_s, ref_i = jax_topk_reference(
            jnp.asarray(q), jnp.asarray(c), k, candidate_mask=jnp.asarray(mask)
        )
        np.testing.assert_array_equal(i, np.asarray(ref_i))
        np.testing.assert_allclose(s, np.asarray(ref_s), atol=1e-6)
        assert (s[:, 4:] == np.float32(-1e30)).all()  # the sentinel past the eligible rows
        assert all(mask[j] == 1 for j in i[:, :4].ravel())
        pal_s, pal_i = cosine_topk_pallas(
            jnp.asarray(q), jnp.asarray(c), k, block_n=128, interpret=True,
            candidate_mask=jnp.asarray(mask),
        )
        np.testing.assert_allclose(s, np.asarray(pal_s), atol=1e-6)
        np.testing.assert_array_equal(i[:, :4], np.asarray(pal_i)[:, :4])
