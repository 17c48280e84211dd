"""The port's shape rehearsal on the CPU: its checkpoint writer
(``scripts/torch_make_rehearsal_checkpoint.py``) gives the JAX script's
state dict and vocab bit for bit, and the rehearsal
(``scripts/torch_rehearsal_real_shapes.py``) runs end to end at a tiny scale,
writing its report under its own workdir only."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

import scripts.make_rehearsal_checkpoint as jax_ckpt
import scripts.torch_make_rehearsal_checkpoint as ckpt
import scripts.torch_rehearsal_real_shapes as rehearsal
from instacart_next_order_recommendation_tpu_torch.models.checkpoint import load_tower

REPO_REPORT = rehearsal._repo_root + "/REHEARSAL_RESULTS.md"


def test_config_vocab_and_state_dict_equal_the_jax_script(tmp_path):
    assert ckpt.MINILM_CONFIG == jax_ckpt.MINILM_CONFIG
    vocab = ckpt.build_vocab(ckpt.MINILM_CONFIG["vocab_size"], 0)
    assert len(vocab) == 30522
    assert vocab == jax_ckpt.build_vocab(jax_ckpt.MINILM_CONFIG["vocab_size"], 0)
    ours = ckpt.build_state_dict(ckpt.MINILM_CONFIG, 0)
    theirs = jax_ckpt.build_state_dict(jax_ckpt.MINILM_CONFIG, 0)
    assert list(ours) == list(theirs)
    for name, t in ours.items():
        assert t.dtype == theirs[name].dtype and torch.equal(t, theirs[name]), name
    # The files: the same tensors back from pytorch_model.bin, the vocab
    # line by line, and the directory loads as an HF tower.
    out = tmp_path / "ckpt"
    info = ckpt.write_checkpoint(out, 0)
    assert info == {"vocab": 30522, "params": sum(t.numel() for t in ours.values())}
    saved = torch.load(out / "pytorch_model.bin", weights_only=True)
    assert all(torch.equal(saved[k], ours[k]) for k in ours)
    assert (out / "vocab.txt").read_text().splitlines() == vocab
    assert json.loads((out / "config.json").read_text()) == ckpt.MINILM_CONFIG
    assert json.loads((out / "tokenizer_config.json").read_text())["do_lower_case"] is True
    params, cfg, tok = load_tower(out)
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers) == (30522, 384, 6)
    assert tok.vocab_size == 30522


def test_rehearsal_end_to_end_at_a_tiny_scale(tmp_path, monkeypatch, capsys):
    # The architecture cut to a tiny width: the recipe (B=64, S=256) stays.
    monkeypatch.setattr(ckpt, "MINILM_CONFIG", {
        **ckpt.MINILM_CONFIG, "hidden_size": 64, "num_attention_heads": 2,
        "intermediate_size": 128, "num_hidden_layers": 2,
    })
    before = hashlib.sha256(open(REPO_REPORT, "rb").read()).hexdigest()
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    torch.set_num_threads(2)
    wd = tmp_path / "ws"
    rc = rehearsal.main(["--users", "60", "--products", "80", "--epochs", "1",
                         "--workdir", str(wd), "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["metric"] == "rehearsal" and summary["device"] == "cpu"
    assert summary["vocab"] == 30522 and summary["padded_seq_len"] == [256]
    assert summary["train_pairs"] > 64 and summary["corpus"] == 80
    assert summary["peak_host_rss_gb"] > 0 and summary["peak_device_gb"] is None
    report = (wd / "REHEARSAL_RESULTS.md").read_text()
    assert report.startswith("> **SHAPE REHEARSAL, NOT REAL DATA.**")
    assert "| ndcg_at_10 |" in report and "Item-item CF (ours / ref)" in report
    assert "peak device memory (torch.cuda.max_memory_allocated): not measured" in report
    assert json.loads((wd / "run" / "model" / "best.json").read_text())["best_epoch"] == 1
    # Nothing outside the workdir: not the repo's JAX account, not a root file.
    assert list(cwd.iterdir()) == []
    assert hashlib.sha256(open(REPO_REPORT, "rb").read()).hexdigest() == before


def test_rehearsal_without_a_card_asks_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rehearsal.main(["--workdir", str(tmp_path / "ws")])
