"""The port's tokenizer against the HF slow ``BertTokenizer`` on a vocab laid
out as BERT's: ``[PAD]`` at 0, ``[unused*]`` rows, ``[UNK]``, ``[CLS]``,
``[SEP]``, ``[MASK]`` at 100-103. A warm-start vocab (all-MiniLM-L6-v2's)
looks like this, where a corpus-trained one puts its special tokens at 0-4.
The battery is JAX's (``tests/test_tokenizer_hf_parity.py``), held through
the Python path and through the native (C++) batch path."""

import os
import random

import pytest
from transformers.models.bert.tokenization_bert import BertTokenizer

from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer

from tests.test_tokenizer_hf_parity import BATTERY, CORPUS

SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def bert_layout(tokens: list[str]) -> list[str]:
    """[PAD], [unused0-98], [UNK], [CLS], [SEP], [MASK], [unused99-199],
    then ``tokens``."""
    return (
        ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"[unused{i}]" for i in range(99, 200)] + tokens
    )


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    trained = WordPieceTokenizer.train(CORPUS, vocab_size=3000, min_frequency=1)
    words = [t for t, _ in sorted(trained.vocab.items(), key=lambda kv: kv[1]) if t not in SPECIAL]
    d = tmp_path_factory.mktemp("bert_vocab")
    (d / "vocab.txt").write_text("".join(t + "\n" for t in bert_layout(words)), encoding="utf-8")
    (d / "tokenizer_config.json").write_text('{"do_lower_case": true}')
    tok = WordPieceTokenizer.load(d)
    hf = BertTokenizer(vocab_file=os.path.join(d, "vocab.txt"), do_lower_case=True)
    return tok, hf


def random_texts(n: int = 150) -> list[str]:
    rng = random.Random(3)
    pool = (
        list(range(0x20, 0x2F0))
        + list(range(0x370, 0x480))
        + [0x4E00 + i for i in range(60)]
        + [0xFF00 + i for i in range(0x50)]
        + [0x2000 + i for i in range(0x40)]
        + [0xFB00 + i for i in range(10)]
    )
    return ["".join(chr(rng.choice(pool)) for _ in range(rng.randint(1, 50))) for _ in range(n)]


def test_special_ids_sit_where_bert_puts_them(pair):
    tok, hf = pair
    assert (tok.pad_id, tok.unk_id, tok.cls_id, tok.sep_id) == (0, 100, 101, 102)
    hf_ids = (hf.pad_token_id, hf.unk_token_id, hf.cls_token_id, hf.sep_token_id)
    assert hf_ids == (0, 100, 101, 102)
    assert tok.vocab_size == len(hf.vocab)


@pytest.mark.parametrize("texts", [BATTERY, random_texts()], ids=["battery", "random_unicode"])
def test_python_path_matches_hf(pair, texts):
    tok, hf = pair
    ids, mask = tok.encode_batch_reference(texts, max_seq_length=512)
    for r, text in enumerate(texts):
        want = hf.encode(text, add_special_tokens=True)
        assert tok.encode(text, max_seq_length=512) == want, repr(text)
        assert [int(x) for x in ids[r][: mask[r].sum()]] == want, repr(text)


@pytest.mark.parametrize("texts", [BATTERY, random_texts()], ids=["battery", "random_unicode"])
def test_native_path_matches_hf(pair, texts):
    tok, hf = pair
    before = tok.native_batches, tok.python_batches
    ids, mask = tok.encode_batch(texts, max_seq_length=512)
    assert (tok.native_batches, tok.python_batches) == (before[0] + 1, before[1])
    for r, text in enumerate(texts):
        assert [int(x) for x in ids[r][: mask[r].sum()]] == hf.encode(
            text, add_special_tokens=True
        ), repr(text)
    assert (ids[mask == 0] == 0).all()  # padding is [PAD], id 0
