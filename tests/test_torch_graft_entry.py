"""The port's harness entry points (``__graft_entry_torch__.py``) on the CPU:
``entry`` against ``__graft_entry__.entry`` on JAX's parameters, and
``dryrun_multichip`` on 2 and 4 gloo ranks (dp=2, and dp=2 x tp=2)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import __graft_entry_torch__ as graft
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import params_from_numpy
from instacart_next_order_recommendation_tpu_torch.models.encoder import MINILM_L6


@pytest.fixture(scope="module")
def entries():
    jfn, jargs = jax_graft.entry()
    fn, args = graft.entry(device="cpu")
    return jfn, jargs, fn, args


def test_entry_is_minilm_at_full_width_on_jax_inputs(entries):
    jfn, jargs, fn, args = entries
    config = fn.keywords["config"]
    assert config == MINILM_L6 and config.to_dict() == jfn.keywords["config"].to_dict()
    assert (config.hidden_size, config.num_heads, config.num_layers) == (384, 12, 6)
    params, ids, mask = args
    assert tuple(ids.shape) == (8, 128) and ids.device.type == "cpu"
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jargs[2]))
    out = fn(*args)  # the entry's own seeded weights, at bf16
    assert out.dtype == torch.float32 and tuple(out.shape) == (8, 384)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_entry_matches_jax_on_its_params(entries, dtype, atol):
    jfn, jargs, fn, args = entries
    jcfg = dataclasses.replace(jfn.keywords["config"], compute_dtype=dtype)
    ref = np.asarray(jax.jit(jfn.func, static_argnames="config")(*jargs, config=jcfg))
    cfg = dataclasses.replace(fn.keywords["config"], compute_dtype=dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jargs[0]))
    out = fn.func(params, args[1], args[2], config=cfg)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)


@pytest.mark.parametrize("n,dp,tp", [(2, 2, 1), (4, 2, 2)])
def test_dryrun_multichip(n, dp, tp):
    out = graft.dryrun_multichip(n, device="cpu")
    assert (out["n"], out["dp"], out["tp"], out["device"]) == (n, dp, tp, "cpu")
    assert np.isfinite(out["loss"])
    ranks = out["ranks"]
    assert sorted(r["rank"] for r in ranks) == list(range(n))
    assert sorted((r["data_rank"], r["model_rank"]) for r in ranks) == [
        (d, m) for d in range(dp) for m in range(tp)
    ]
    assert all(r["topk_exact"] and r["masked_ok"] and r["catalog_shards"] == dp for r in ranks)
    # On the CPU every wrapper takes its plain version: no launches.
    assert not any(out["launches"].values())


def test_dryrun_without_a_card_asks_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft.dryrun_multichip(2)
