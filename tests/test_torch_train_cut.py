"""A train step that runs each tower only as wide as its longest real row
(``encoder.tower_widths``, ``encode``'s ``width``), on the CPU: the loss and
gradients against JAX's at the handed width, the loss, gradients, dropout
masks and generator state of a plain uncut step, the cut counter, and an
inference encode left uncut. Over the fused and unfused routes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instacart_next_order_recommendation_tpu.models import (
    TowerConfig as JaxTowerConfig,
    encode as jax_encode,
    init_params as jax_init_params,
)
from instacart_next_order_recommendation_tpu.ops.mnrl import mnrl_loss as jax_mnrl_loss
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_from_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    TowerConfig,
    _encoder_layer,
    embed,
    encode,
    prepare_layers,
    tower_widths,
)
from instacart_next_order_recommendation_tpu_torch.ops import (
    fused_encoder_layer,
    masked_mean_pool_l2norm,
    mnrl_loss,
)
from instacart_next_order_recommendation_tpu_torch.ops.fused_layer import (
    draw_dropout_masks,
    supports,
)
from instacart_next_order_recommendation_tpu_torch.train.trainer import (
    TrainStep,
    build_optimizer,
    param_leaves,
    warmup_cosine_schedule,
)
from instacart_next_order_recommendation_tpu_torch.utils import profiling

# Both towers' widths: head_dim 32 takes the fused layer at S % 16 == 0,
# head_dim 24 the unfused one at every S.
WIDTHS = {
    "fused": dict(hidden_size=64, num_heads=2, intermediate_size=128),
    "unfused": dict(hidden_size=48, num_heads=2, intermediate_size=96),
    "unfused_remat": dict(hidden_size=48, num_heads=2, intermediate_size=96),
}
ROUTES = list(WIDTHS)
HANDED = 64  # the width every batch is handed at
SHORT = 24  # the longest positive of a batch that the cut narrows
SCALE = 30.0
VOCAB = 120


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def tiny_pair(route: str, dropout: float):
    cfg = JaxTowerConfig(
        vocab_size=VOCAB, num_layers=2, max_position=HANDED, compute_dtype="float32",
        hidden_dropout=dropout, **WIDTHS[route],
    )
    jax_params = jax_init_params(cfg, jax.random.key(7))
    port_cfg = TowerConfig.from_dict(cfg.to_dict())
    port_cfg = dataclasses.replace(port_cfg, remat=route == "unfused_remat")
    return cfg, jax_params, port_cfg, jax.tree.map(np.asarray, jax_params)


def trainable(np_params):
    return jax.tree.map(lambda t: t.requires_grad_(True), params_from_numpy(np_params))


def batch(seed: int, short: int | None = SHORT, rows: int = 8) -> list[np.ndarray]:
    """Anchors with one row that fills the handed width; positives of at
    most ``short`` tokens (None: one fills the width too)."""
    rng = np.random.default_rng(seed)
    out = []
    for longest in (HANDED, short or HANDED):
        lengths = rng.integers(4, longest + 1, size=rows)
        lengths[0] = longest
        mask = (np.arange(HANDED)[None] < lengths[:, None]).astype(np.int32)
        ids = np.where(mask == 1, rng.integers(5, VOCAB, size=(rows, HANDED)), 0)
        out += [ids.astype(np.int32), mask]
    return out


def step_of(params, cfg, accum: int = 2) -> TrainStep:
    """A step that only accumulates (``accum`` 2), so the gradients stay."""
    return TrainStep(
        params, cfg, build_optimizer(params, 0.0), warmup_cosine_schedule(1e-3, 10),
        loss_scale=SCALE, accum=accum, device=torch.device("cpu"),
    )


def test_tower_widths_round_the_last_real_column_up_to_16():
    mask = torch.zeros((3, 64), dtype=torch.int32)
    mask[0, :5] = 1
    mask[2, 10:17] = 1  # not a prefix: the last real column counts
    full = torch.ones((2, 40), dtype=torch.int32)
    empty = torch.zeros((2, 48), dtype=torch.int32)
    assert tower_widths(mask, full, empty) == [32, 40, 16]
    assert tower_widths(torch.from_numpy(batch(0)[1]), torch.from_numpy(batch(0)[3])) == [64, 32]


@pytest.mark.parametrize("route", ROUTES)
def test_a_cut_step_matches_jax_at_the_handed_width(route):
    """(a) Dropout 0, f32: the cut step's loss and every leaf's gradient
    against JAX's ``value_and_grad`` on the batch as handed."""
    cfg, jax_params, port_cfg, np_params = tiny_pair(route, 0.0)
    data = batch(22)
    assert supports(port_cfg.hidden_size, port_cfg.num_heads, 32, port_cfg.intermediate_size) == (
        route == "fused"
    )

    def loss_fn(p, a_ids, a_mask, p_ids, p_mask):
        qa = jax_encode(p, a_ids, a_mask, cfg)
        return jax_mnrl_loss(qa, jax_encode(p, p_ids, p_mask, cfg), scale=SCALE)

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(
        jax_params, *(jnp.asarray(b) for b in data)
    )
    params = trainable(np_params)
    with profile(activities=[ProfilerActivity.CPU]):
        loss = step_of(params, port_cfg)([torch.from_numpy(b) for b in data], seed=0)
    assert profiling.counters()["tower.cut_slots"] == 8 * (HANDED - 32)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    theirs = dict(param_leaves(jax.tree.map(np.asarray, grads_ref)))
    for name, t in param_leaves(params):
        # The backward holds loss / accum; f32 sums in another order.
        np.testing.assert_allclose(
            2 * t.grad.numpy(), theirs[name], atol=2e-6, rtol=2e-4, err_msg=name
        )


def plain_step(params, cfg: TowerConfig, data, seed: int):
    """The uncut step, built here: one generator seeded with ``seed`` draws
    at the handed ``[B, S, H]`` shape, anchors then positives, the
    embeddings' mask, then m1 and m2 of each layer; the unfused layer at the
    full width, the pool, MNRL. Returns the loss and the generator."""
    gen = torch.Generator().manual_seed(seed)
    keep = 1.0 - cfg.hidden_dropout
    layers = prepare_layers(params, cfg)

    def draw(shape):
        return torch.rand(shape, generator=gen) < keep

    def tower(ids, mask):
        x = embed(params, ids, cfg)  # f32 at compute dtype float32
        x = torch.where(draw(x.shape), x / keep, 0.0)
        for layer in layers:
            m1, m2 = (torch.where(draw(x.shape), 1.0 / keep, 0.0) for _ in range(2))
            x = _encoder_layer(x, layer, mask, cfg, (m1, m2))
        return masked_mean_pool_l2norm(x, mask)

    a_ids, a_mask, p_ids, p_mask = data
    qa = tower(a_ids, a_mask)
    return mnrl_loss(qa, tower(p_ids, p_mask), scale=SCALE), gen


@pytest.mark.parametrize("route", ROUTES)
def test_a_cut_step_equals_the_uncut_step_with_dropout(route):
    """(b) Dropout 0.1: the loss, every gradient and the generator's state
    after the step are those of the plain uncut step."""
    _, _, port_cfg, np_params = tiny_pair(route, 0.1)
    data = [torch.from_numpy(b) for b in batch(23)]
    params = trainable(np_params)
    step = step_of(params, port_cfg)
    loss = step(data, seed=11)
    ref = trainable(np_params)
    ref_loss, gen = plain_step(ref, port_cfg, data, seed=11)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-6, atol=0.0)
    for (name, t), (_, r) in zip(param_leaves(params), param_leaves(ref)):
        # 2 x: the step's backward holds loss / accum. f32 sums over the
        # cut's fewer (all-pad) rows in another order.
        torch.testing.assert_close(2 * t.grad, r.grad, rtol=1e-4, atol=1e-6, msg=name)
    assert torch.equal(step.generator.get_state(), gen.get_state())


@pytest.mark.parametrize("width", [16, 40, 64])
def test_masks_drawn_at_the_handed_shape_then_cut_are_the_uncut_masks(width):
    shape = (3, 64, 8)
    cut = draw_dropout_masks(shape, 0.1, g := torch.Generator().manual_seed(5), "cpu",
                             torch.bfloat16, width=width)
    whole = draw_dropout_masks(shape, 0.1, h := torch.Generator().manual_seed(5), "cpu",
                               torch.bfloat16)
    for c, w in zip(cut, whole):
        assert c.shape == (3, width, 8) and c.is_contiguous()
        assert torch.equal(c, w[:, :width])
    assert torch.equal(g.get_state(), h.get_state())


@pytest.mark.parametrize("short", [SHORT, None], ids=["cut", "filled"])
def test_the_cut_is_counted_only_where_a_tower_runs_narrower(short):
    """(c) ``tower.cut_slots`` is rows x (handed - width) of each side that
    cuts; absent where every side's rows fill the handed width.
    ``tower.slots`` stays rows x handed width."""
    _, _, port_cfg, np_params = tiny_pair("fused", 0.1)
    data = [torch.from_numpy(b) for b in batch(24, short=short)]
    with profile(activities=[ProfilerActivity.CPU]):
        step_of(trainable(np_params), port_cfg, accum=1)(data, seed=3)
    c = profiling.counters()
    assert c["tower.rows"] == 16 and c["tower.slots"] == 16 * HANDED
    assert c["tower.tokens"] == int(data[1].sum() + data[3].sum())
    if short is None:
        assert "tower.cut_slots" not in c
    else:
        assert c["tower.cut_slots"] == 8 * (HANDED - 32)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_an_inference_encode_runs_at_the_handed_width(route):
    """(d) Without a generator: no cut on a mask with trailing pad columns,
    the layers run at the full width as before, nothing cut is counted."""
    _, _, port_cfg, np_params = tiny_pair(route, 0.1)
    params = params_from_numpy(np_params)
    ids, mask = (torch.from_numpy(b) for b in batch(25, short=SHORT)[2:])
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        got = encode(params, ids, mask, port_cfg)
    c = profiling.counters()
    assert "tower.cut_slots" not in c and c["tower.slots"] == 8 * HANDED
    with torch.no_grad():
        x = embed(params, ids, port_cfg)
        for layer in prepare_layers(params, port_cfg):
            if route == "fused":
                x = fused_encoder_layer(x, mask, layer, num_heads=port_cfg.num_heads,
                                        scale=1.0 / (port_cfg.head_dim**0.5),
                                        eps=port_cfg.layer_norm_eps)
            else:
                x = _encoder_layer(x, layer, mask, port_cfg)
        want = masked_mean_pool_l2norm(x, mask)
    assert x.shape[1] == HANDED
    assert torch.equal(got, want)
