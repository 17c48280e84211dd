"""The port's ops on the CPU (their plain versions) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles. The CUDA
kernels themselves are held against the plain versions on the GPU in
tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from instacart_next_order_recommendation_tpu.ops import fused_layer as jax_fused
from instacart_next_order_recommendation_tpu.ops.mnrl import mnrl_loss as jax_mnrl_loss
from instacart_next_order_recommendation_tpu.ops.pool_norm import (
    _pool_bwd as jax_pool_bwd,
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
    fused_encoder_layer_backward,
    fused_encoder_layer_train,
    masked_mean_pool_l2norm,
    mnrl_loss,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    WEIGHT_NAMES,
    fused_encoder_layer_reference,
    prepare_layer,
)

HIDDEN, INTER, HEADS = 128, 256, 4
SCALE = 1.0 / (HIDDEN // HEADS) ** 0.5
EPS = 1e-12
# head_dim 64, as mpnet-base-class: the port's fused kernels take it too.
HEADS_64 = HIDDEN // 64


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


def _heads_kw(heads=HEADS):
    return dict(num_heads=heads, scale=1.0 / (HIDDEN // heads) ** 0.5, eps=EPS)


def _port_layer(x_np, mask_np, layer, dtype, heads=HEADS):
    x = torch.from_numpy(x_np).to(dtype)
    mask = torch.from_numpy(mask_np)
    L = {k: torch.from_numpy(v) for k, v in layer.items()}
    return fused_encoder_layer(x, mask, L, **_heads_kw(heads))


def _as_np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


class TestFusedLayer:
    @pytest.mark.parametrize(
        "dtype,atol,rtol,batch,seq,all_pad,heads",
        [
            pytest.param("float32", 1e-4, 0.0, 2, 64, False, HEADS,
                         id="float32-0.0001-0.0-2-64-False"),
            pytest.param("float32", 1e-4, 0.0, 3, 32, True, HEADS,
                         id="float32-0.0001-0.0-3-32-True"),
            pytest.param("bfloat16", 2e-2, 1e-2, 3, 32, True, HEADS,
                         id="bfloat16-0.02-0.01-3-32-True"),
            pytest.param("float32", 1e-4, 0.0, 2, 64, False, HEADS_64,
                         id="head_dim_64-float32-2-64-False"),
            pytest.param("float32", 1e-4, 0.0, 3, 48, True, HEADS_64,
                         id="head_dim_64-float32-3-48-True"),
            pytest.param("bfloat16", 2e-2, 1e-2, 3, 48, True, HEADS_64,
                         id="head_dim_64-bfloat16-3-48-True"),
        ],
    )
    def test_matches_jax_kernel_and_oracle(self, dtype, atol, rtol, batch, seq, all_pad, heads):
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
        kw = _heads_kw(heads)
        kernel = jax_fused._call(x, bias, *weights, **kw, interpret=True)
        oracle = jax_fused._oracle(x, bias, None, None, *weights, **kw)
        port = _port_layer(x_np, mask_np, layer, tdt, heads)
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


def _dropout_np(rng, shape, dtype, keep=0.9):
    """{0, 1/keep} masks made with numpy, fed to both packages."""
    masks = [
        np.where(rng.random(shape) < keep, np.float32(1.0 / keep), np.float32(0.0))
        for _ in range(2)
    ]
    return [jnp.asarray(m, dtype) for m in masks], [torch.from_numpy(m) for m in masks]


class TestFusedLayerTrain:
    """The training form (masks) and its backward against the JAX package:
    ``jax.vjp`` of ``_oracle`` and the Pallas ``_bwd_kernel`` in interpret
    mode (``_fused_backward``, wgrads form), on the same numpy inputs."""

    def _case(self, seq, dropout, dtype="float32", batch=2, seed=10, heads=HEADS):
        rng = np.random.default_rng(seed)
        layer = _layer_np(rng)
        x_np = (0.3 * rng.standard_normal((batch, seq, HIDDEN))).astype(np.float32)
        mask_np = _mask_np(rng, batch, seq)  # no all-pad row (see the JAX kernel quirk)
        g_np = rng.standard_normal((batch, seq, HIDDEN)).astype(np.float32)
        cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "float32" else torch.bfloat16
        x, bias, weights = _jax_layer_args(x_np, mask_np, layer, cdt)
        j_masks, t_masks = (), None
        if dropout:
            j_masks, t_masks = _dropout_np(rng, x_np.shape, cdt)
            t_masks = tuple(m.to(tdt) for m in t_masks)
        m1, m2 = j_masks if dropout else (None, None)
        kw = _heads_kw(heads)
        y_ref, vjp = jax.vjp(
            lambda x_, *w: jax_fused._oracle(x_, bias, m1, m2, *w, **kw), x, *weights
        )
        g = jnp.asarray(g_np, cdt)
        dx_ref, *dw_ref = vjp(g)
        port_w = prepare_layer({k: torch.from_numpy(v) for k, v in layer.items()}, tdt)
        xt = torch.from_numpy(x_np).to(tdt)
        bias_t = torch.from_numpy((1.0 - mask_np.astype(np.float32)) * -1e9)
        port = dict(
            y=fused_encoder_layer_train(
                xt, torch.from_numpy(mask_np), port_w, masks=t_masks,
                dropout_rate=0.1 if dropout else 0.0, **kw,
            ),
            grads=fused_encoder_layer_backward(
                xt, bias_t, torch.from_numpy(g_np).to(tdt), t_masks, port_w, **kw
            ),
        )
        jax_ref = dict(y=y_ref, dx=dx_ref, dw=dw_ref, x=x, bias=bias, g=g,
                       masks=j_masks, weights=weights, kw=kw)
        return port, jax_ref

    @staticmethod
    def _assert_grads(port_grads, dx_ref, dw_ref, atol, rtol=0.0):
        dx, dw = port_grads
        np.testing.assert_allclose(_as_np(dx), _as_np(dx_ref), atol=atol, rtol=rtol)
        for name, ref in zip(WEIGHT_NAMES, dw_ref):
            np.testing.assert_allclose(
                _as_np(dw[name]).reshape(-1), _as_np(ref).reshape(-1), atol=atol, rtol=rtol,
                err_msg=f"grad mismatch for {name}",
            )

    @pytest.mark.parametrize(
        "seq,dropout,heads",
        [
            pytest.param(48, True, HEADS, id="48-True"),
            pytest.param(48, False, HEADS, id="48-False"),
            pytest.param(128, True, HEADS, id="128-True"),
            pytest.param(128, False, HEADS, id="128-False"),
            pytest.param(48, True, HEADS_64, id="head_dim_64-48-True"),
        ],
    )
    def test_forward_and_plain_backward_match_oracle_vjp(self, seq, dropout, heads):
        port, ref = self._case(seq, dropout, heads=heads)
        np.testing.assert_allclose(_as_np(port["y"]), _as_np(ref["y"]), atol=1e-4)
        # f32: the JAX oracle's A&S erf (< 2e-6) against torch.erf, and sums
        # in another order.
        self._assert_grads(port["grads"], ref["dx"], ref["dw"], atol=1e-4)

    @pytest.mark.parametrize(
        "seq,dropout,heads",
        [
            pytest.param(48, True, HEADS, id="48-True"),
            pytest.param(128, False, HEADS, id="128-False"),
            pytest.param(48, True, HEADS_64, id="head_dim_64-48-True"),
            pytest.param(128, False, HEADS_64, id="head_dim_64-128-False"),
        ],
    )
    def test_plain_backward_matches_jax_bwd_kernel(self, seq, dropout, heads):
        port, ref = self._case(seq, dropout, heads=heads)
        dx_k, dw_k = jax_fused._fused_backward(
            ref["x"], ref["bias"], tuple(ref["masks"]), ref["weights"], ref["g"],
            **ref["kw"], interpret=True, wgrads=True,
        )
        # The JAX package's own kernel-vs-oracle tolerance (tests/test_ops.py).
        self._assert_grads(port["grads"], dx_k, dw_k, atol=3e-4)

    def test_bf16_matches_oracle_vjp(self):
        # bf16 activations round at the same cast points in both packages,
        # but another summation order can flip a rounding (one bf16 ulp is
        # 2^-8 relative); the grads compound a few such steps, so the bound
        # is 5e-2 absolute at unit-scale inputs.
        port, ref = self._case(48, True, dtype="bfloat16")
        np.testing.assert_allclose(_as_np(port["y"]), _as_np(ref["y"]), atol=2e-2, rtol=1e-2)
        self._assert_grads(port["grads"], ref["dx"], ref["dw"], atol=5e-2, rtol=2e-2)

    def test_keep_one_is_the_maskless_form(self):
        rng = np.random.default_rng(11)
        layer = {k: torch.from_numpy(v) for k, v in _layer_np(rng).items()}
        x = torch.from_numpy((0.3 * rng.standard_normal((2, 16, HIDDEN))).astype(np.float32))
        mask = torch.from_numpy(_mask_np(rng, 2, 16))
        kw = dict(num_heads=HEADS, scale=SCALE, eps=EPS)
        y = fused_encoder_layer_train(x, mask, layer, dropout_rate=0.0, **kw)
        assert torch.equal(y, fused_encoder_layer_reference(x, mask, layer, **kw))
        with pytest.raises(ValueError, match="generator"):
            fused_encoder_layer_train(x, mask, layer, dropout_rate=0.1, **kw)
        gen = torch.Generator().manual_seed(0)
        y_drop = fused_encoder_layer_train(x, mask, layer, generator=gen, dropout_rate=0.1, **kw)
        assert not torch.equal(y_drop, y)
        assert fused_encoder_layer_train.launches == 0  # the CPU never counts a launch


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

    def test_gradient_matches_jax(self):
        rng = np.random.default_rng(12)
        hidden = rng.standard_normal((3, 32, HIDDEN)).astype(np.float32)
        mask = _mask_np(rng, 3, 32, all_pad_row=True)
        g = rng.standard_normal((3, HIDDEN)).astype(np.float32)
        h = torch.from_numpy(hidden).requires_grad_(True)
        masked_mean_pool_l2norm(h, torch.from_numpy(mask)).backward(torch.from_numpy(g))
        ref, _ = jax_pool_bwd((jnp.asarray(hidden), jnp.asarray(mask)), jnp.asarray(g))
        ref = np.asarray(ref)
        np.testing.assert_allclose(h.grad.numpy()[:-1], ref[:-1], atol=1e-6)
        # An all-pad row pools to the zero vector, where the L2 norm has no
        # gradient: JAX's is NaN there, torch's vector_norm gives 0.
        assert np.isnan(ref[-1]).all()
        assert (h.grad.numpy()[-1] == 0).all()


class TestMnrl:
    @pytest.mark.parametrize("scale", [30.0, 50.0])
    def test_matches_jax(self, scale):
        rng = np.random.default_rng(13)
        q, p = (rng.standard_normal((16, 64)).astype(np.float32) for _ in range(2))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        qt, pt = torch.from_numpy(q).requires_grad_(True), torch.from_numpy(p).requires_grad_(True)
        loss = mnrl_loss(qt, pt, scale=scale)
        loss.backward()
        ref, (gq, gp) = jax.value_and_grad(
            lambda a, b: jax_mnrl_loss(a, b, scale=scale), argnums=(0, 1)
        )(jnp.asarray(q), jnp.asarray(p))
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
        np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq), atol=1e-6)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp), atol=1e-6)


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
