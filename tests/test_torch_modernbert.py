"""The port's ModernBERT tower on the CPU, against transformers' ModernBertModel.

At a size where both kinds of layer bite (hidden 128, 2 heads of 64, 4
layers so that layers 0 and 3 are global, a 16-token window, S = 80 with
padded rows), on seeded random weights, in f32: the port's ``encode`` is
held to ``transformers.ModernBertModel`` (eager attention, built from a
``ModernBertConfig`` in code) and to the benchmark's plain reference, and
each planted fault (the window widened to global, the RoPE thetas swapped,
GeGLU's halves swapped) breaks the agreement. Also: the length buckets past
512, and BERT configs saving and routing as before.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from instacart_next_order_recommendation_tpu.models.encoder import TowerConfig as JaxTowerConfig

from instacart_next_order_recommendation_tpu_torch.models import modernbert
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower, save_tower
from instacart_next_order_recommendation_tpu_torch.models.encoder import (
    MINILM_L6,
    MODERNBERT_BASE,
    MPNET_BASE_CLASS,
    TowerConfig,
    encode,
    init_params,
    prepare_layers,
)
from instacart_next_order_recommendation_tpu_torch.ops import modernbert as mb_ops
from instacart_next_order_recommendation_tpu_torch.tokenizer import LENGTH_BUCKETS, bucket_length
from instacart_next_order_recommendation_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
TINY = dataclasses.replace(
    MODERNBERT_BASE, vocab_size=300, hidden_size=128, num_layers=4, num_heads=2,
    intermediate_size=192, max_position=128, max_seq_length=128, local_attention=16,
    compute_dtype="float32",
)
B, S = 3, 80
LENGTHS = (80, 57, 9)
TOL = 1e-5  # f32 against f32: the same equations, summed in other orders
FAULT = 1e-2  # the least a planted fault moves the embeddings here (4e-2 to 0.3 read)


def _inputs():
    rng = np.random.default_rng(7)
    ids = rng.integers(5, TINY.vocab_size, size=(B, S))
    mask = np.zeros((B, S), np.int32)
    for r, n in enumerate(LENGTHS):
        mask[r, :n] = 1
    ids = np.where(mask == 1, ids, 0)
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def params():
    """ModernBERT's init, the projections scaled up (in x8, out x10) so that
    attention is far from uniform: at the published 0.02 a 4-layer tower's
    answer barely depends on where it attends (a swap of the thetas moved
    it by 1.7e-5), and no fault would show."""
    p = init_params(TINY, torch.Generator().manual_seed(3))
    for name, k in (("qkv_w", 8.0), ("wi", 8.0), ("o_w", 10.0), ("wo_mlp", 10.0)):
        p["layers"][name] *= k
    return p


def _hf_model(params, config=TINY):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.ModernBertConfig(
        vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size, num_hidden_layers=config.num_layers,
        num_attention_heads=config.num_heads, max_position_embeddings=config.max_position,
        local_attention=config.local_attention,
        global_attn_every_n_layers=config.global_attn_every_n_layers,
        global_rope_theta=config.global_rope_theta, local_rope_theta=config.local_rope_theta,
        norm_eps=config.layer_norm_eps, pad_token_id=0, reference_compile=False,
        attn_implementation="eager",
    )
    model = transformers.ModernBertModel(hf_cfg).eval()
    emb, lw = params["embeddings"], params["layers"]
    state = {"embeddings.tok_embeddings.weight": emb["word"],
             "embeddings.norm.weight": emb["ln_scale"],
             "final_norm.weight": params["final"]["ln_scale"]}
    for i in range(config.num_layers):
        pre = f"layers.{i}."
        state[pre + "attn.Wqkv.weight"] = lw["qkv_w"][i].T
        state[pre + "attn.Wo.weight"] = lw["o_w"][i].T
        state[pre + "mlp.Wi.weight"] = lw["wi"][i].T
        state[pre + "mlp.Wo.weight"] = lw["wo_mlp"][i].T
        state[pre + "mlp_norm.weight"] = lw["mlp_ln_scale"][i]
        if i:
            state[pre + "attn_norm.weight"] = lw["attn_ln_scale"][i]
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and not [k for k in missing if "rotary" not in k], (missing, unexpected)
    return model


def _hf_embed(model, ids, mask):
    with torch.no_grad():
        h = model(input_ids=ids, attention_mask=mask).last_hidden_state
    m = mask.to(torch.float32)[..., None]
    mean = (h * m).sum(1) / m.sum(1)
    return mean / mean.norm(dim=-1, keepdim=True)


def _reference():
    sys.path.insert(0, str(ROOT))
    from benchmark.reference import modernbert as ref

    return ref


def _ref_cfg(config=TINY):
    return {
        "hidden_size": config.hidden_size, "num_attention_heads": config.num_heads,
        "num_hidden_layers": config.num_layers, "intermediate_size": config.intermediate_size,
        "norm_eps": config.layer_norm_eps, "local_attention": config.local_attention,
        "global_attn_every_n_layers": config.global_attn_every_n_layers,
        "global_rope_theta": config.global_rope_theta, "local_rope_theta": config.local_rope_theta,
    }


def _gap(a, b):
    return float((a - b).abs().max())


def test_encode_matches_transformers_and_the_reference(params):
    ids, mask = _inputs()
    with torch.no_grad():
        ours = encode(params, ids, mask, TINY)
    hf = _hf_embed(_hf_model(params), ids, mask)
    assert _gap(ours, hf) < TOL
    ref = _reference()
    with torch.no_grad():
        got = ref.embed(params, ids, mask, _ref_cfg())
    assert _gap(ours, got) < TOL
    # Both kinds of layer bite: widening the window moves the answer.
    wide = encode(params, ids, mask, dataclasses.replace(TINY, local_attention=4096))
    assert _gap(ours, wide) > FAULT


@pytest.mark.parametrize("fault", ["window_global", "thetas_swapped", "geglu_swapped",
                                   "window_everywhere"])
def test_planted_faults_break_the_agreement(params, fault):
    """Each fault, planted in the port's forward, moves the embeddings far
    past the tolerance that the sound forward keeps to transformers."""
    ids, mask = _inputs()
    hf = _hf_embed(_hf_model(params), ids, mask)
    config, p = TINY, params
    if fault == "window_global":
        config = dataclasses.replace(TINY, local_attention=4 * S)
    elif fault == "window_everywhere":
        config = dataclasses.replace(TINY, global_attn_every_n_layers=10**6)
    elif fault == "thetas_swapped":
        config = dataclasses.replace(TINY, global_rope_theta=TINY.local_rope_theta,
                                     local_rope_theta=TINY.global_rope_theta)
    else:
        inter = TINY.intermediate_size
        wi = params["layers"]["wi"]
        p = {**params, "layers": {**params["layers"],
                                  "wi": torch.cat([wi[..., inter:], wi[..., :inter]], -1)}}
    if fault == "window_everywhere":
        # Layer 0 stays global under any period; the fault is layer 3 windowed.
        assert modernbert.is_global(config, 0) and not modernbert.is_global(config, 3)
    with torch.no_grad():
        broken = encode(p, ids, mask, config)
    assert _gap(broken, hf) > FAULT


def test_the_layer_and_its_attention_agree_with_the_reference(params):
    """``modernbert_layer`` on the CPU is the reference's layer, global and
    banded; the standalone attention is the layer's."""
    ref = _reference()
    ids, mask = _inputs()
    layers = prepare_layers(params, TINY)
    x = torch.randn(B, S, TINY.hidden_size, generator=torch.Generator().manual_seed(1))
    for i in (0, 1):
        theta, half = modernbert.layer_attention(TINY, i)
        got = mb_ops.modernbert_layer(x, mask, layers[i], num_heads=TINY.num_heads,
                                      eps=TINY.layer_norm_eps, theta=theta, half=half)
        want = ref.layer(params, i, x, mask, _ref_cfg())
        real = mask.bool()
        assert _gap(got[real], want[real]) < TOL
    qkv = torch.randn(B, S, 3 * TINY.hidden_size, generator=torch.Generator().manual_seed(2))
    for half in (-1, 8):
        cos, sin = mb_ops.rope_tables(S, 10000.0, "cpu")
        got = mb_ops.modernbert_attention(qkv, mask, num_heads=2, theta=10000.0, half=half)
        want = mb_ops.attention_reference(qkv, mask, cos, sin, num_heads=2, half=half)
        assert torch.equal(got, want)


def test_bf16_cast_points_stay_near_f32(params):
    """The compute dtype bf16 (the card's) on the CPU: the same tower within
    bf16's rounding of the f32 one."""
    ids, mask = _inputs()
    with torch.no_grad():
        f32 = encode(params, ids, mask, TINY)
        bf = encode(params, ids, mask, dataclasses.replace(TINY, compute_dtype="bfloat16"))
    assert bf.dtype == torch.float32
    assert 0 < _gap(f32, bf) < 2e-2


def test_cpu_route_is_differentiable(params):
    ids, mask = _inputs()
    p = {g: {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
         for g, leaves in params.items()}
    encode(p, ids, mask, TINY).sum().backward()
    assert p["layers"]["wi"].grad is not None and p["layers"]["wi"].grad.abs().sum() > 0
    assert p["final"]["ln_scale"].grad is not None


def test_counters_and_span(params):
    """``encode`` keeps ``tower.encode`` and its counters for ModernBERT;
    the attention counts its pairs by the kind of layer."""
    ids, mask = _inputs()
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            encode(params, ids, mask, TINY)
    c = profiling.counters()
    names = {s.name for s in profiling.spans()}
    profiling.clear()
    assert "tower.encode" in names
    assert c["tower.rows"] == B and c["tower.slots"] == B * S
    assert c["tower.tokens"] == sum(LENGTHS)
    assert c["attn.pairs.full"] == TINY.num_layers * B * S * S
    assert c["attn.pairs.global"] == 2 * B * S * S  # layers 0 and 3
    assert c["attn.pairs.window"] == 2 * B * mb_ops.window_pairs(S, 8)


@pytest.mark.parametrize("seq,half", [(80, 8), (64, 64), (200, 64), (8192, 64), (1000, 64),
                                      (30, 64)])
def test_window_pairs_are_the_scheduled_tiles(seq, half):
    """The counted pairs are those of the key tiles the banded kernel
    schedules (every key within ``half`` of a tile's queries), cut at S: at
    least the band's own pairs, and at 64 no more than three tiles a tile."""
    band = sum(min(i + half, seq - 1) - max(i - half, 0) + 1 for i in range(seq))
    got = mb_ops.window_pairs(seq, half)
    assert band <= got <= min(seq * seq, 3 * 64 * seq)
    tiles = -(-seq // 64)
    want = 0
    for qt in range(tiles):
        keys = {k for i in range(qt * 64, min(seq, qt * 64 + 64))
                for k in range(max(0, i - half), min(seq, i + half + 1))}
        kt = {k // 64 for k in keys}
        want += (min(seq, qt * 64 + 64) - qt * 64) * sum(min(seq, t * 64 + 64) - t * 64 for t in kt)
    if seq <= 1000:
        assert got == want


def test_length_buckets_past_512():
    """A deliberate departure from the JAX package: buckets every 256
    tokens from 512 up to 8,192; those at and under 512 are JAX's."""
    assert LENGTH_BUCKETS[:11] == (16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 512)
    past = LENGTH_BUCKETS[11:]
    assert past[0] == 768 and past[-1] == 8192
    assert all(b - a == 256 for a, b in zip(LENGTH_BUCKETS[10:], LENGTH_BUCKETS[11:]))
    assert bucket_length(1100, 8192) == 1280
    assert bucket_length(8000, 8192) == 8192
    assert bucket_length(600, 512) == 512
    for n in range(1, 513):
        assert bucket_length(n, 256) == min(next(b for b in LENGTH_BUCKETS if b >= n), 256)


def test_bert_configs_save_and_route_as_before(tmp_path):
    """A BERT config's dict, and so its saved model_config.json, holds only
    BERT's keys; ModernBERT's round-trips through a tower directory."""
    for cfg in (MINILM_L6, MPNET_BASE_CLASS):
        d = cfg.to_dict()
        assert "architecture" not in d and "local_attention" not in d
        assert TowerConfig.from_dict(d) == cfg
    tiny_bert = dataclasses.replace(MINILM_L6, vocab_size=50, hidden_size=64, num_layers=1,
                                    num_heads=2, intermediate_size=64, max_position=32)
    save_tower(tmp_path / "bert", init_params(tiny_bert, torch.Generator().manual_seed(0)),
               tiny_bert)
    saved = json.loads((tmp_path / "bert" / "model_config.json").read_text())
    assert saved == JaxTowerConfig(**saved).to_dict()  # every key the JAX package's
    assert TowerConfig.from_dict(saved) == tiny_bert
    tiny = dataclasses.replace(TINY, num_layers=2, vocab_size=40)
    p = init_params(tiny, torch.Generator().manual_seed(0))
    save_tower(tmp_path / "mb", p, tiny)
    p2, cfg2, _ = load_tower(tmp_path / "mb")
    assert cfg2 == tiny
    assert torch.equal(p2["layers"]["wi"], p["layers"]["wi"])
    with pytest.raises(ValueError, match="architecture"):
        TowerConfig(architecture="gpt")
    # A BERT tower still takes BERT's route: no ModernBERT layer runs.
    ids = torch.randint(5, 50, (2, 16), generator=torch.Generator().manual_seed(0))
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            encode(init_params(tiny_bert, torch.Generator().manual_seed(0)), ids,
                   torch.ones_like(ids), tiny_bert)
    c = profiling.counters()
    profiling.clear()
    assert c["tower.rows"] == 2 and not any(k.startswith("attn.pairs") for k in c)


def test_init_is_modernbert_s():
    """Normals cut at two deviations; std 0.02 in, 0.02 / sqrt(2 L) out."""
    cfg = dataclasses.replace(TINY, hidden_size=256, num_heads=4, intermediate_size=512)
    p = init_params(cfg, torch.Generator().manual_seed(5))
    out = 0.02 / (2 * cfg.num_layers) ** 0.5
    for name, std in (("qkv_w", 0.02), ("wi", 0.02), ("o_w", out), ("wo_mlp", out)):
        w = p["layers"][name]
        assert w.abs().max() <= 2 * std + 1e-7
        assert abs(float(w.std()) / std - 0.88) < 0.03  # a normal cut at 2 sd: 0.880 sd
    assert sorted(p) == ["embeddings", "final", "layers"]
