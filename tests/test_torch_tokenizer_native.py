"""The port's C++ tokenizer path (``tokenizer/native.py`` over
``native/wordpiece.cpp``) against its own pure-Python batch encode and
against the JAX package's native tokenizer, on one vocab and the same texts;
its build (concurrent, and failing) and the routes its counters record."""

import random
import subprocess
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from instacart_next_order_recommendation_tpu.tokenizer import (
    WordPieceTokenizer as JaxWordPieceTokenizer,
)
from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer
from instacart_next_order_recommendation_tpu_torch.tokenizer import native

REPO = Path(__file__).resolve().parents[1]
CORPUS = [
    "Product: Organic Milk. Aisle: milk. Department: dairy eggs.",
    "Product: Whole Wheat Bread 2% extra-fine (sliced)! Aisle: bread.",
    "[+7d w4h14] Organic Milk, Whole Wheat Bread. Next: +3d w1h9",
    "numbers 123 456 mixed42tokens UPPER lower MiXeD",
]


@pytest.fixture(scope="module")
def toks():
    ours = WordPieceTokenizer.train(CORPUS, vocab_size=800, min_frequency=1)
    theirs = JaxWordPieceTokenizer(dict(ours.vocab), lowercase=ours.lowercase)
    assert theirs._get_native() is not None, "the JAX package's native tokenizer did not build"
    return ours, theirs


def _same(toks, texts, **kw):
    """Encode through the port's native path, assert that route was taken,
    and hold ids and masks to the port's Python path and to JAX's native."""
    ours, theirs = toks
    native_before, python_before = ours.native_batches, ours.python_batches
    ids, mask = ours.encode_batch(texts, **kw)
    assert (ours.native_batches, ours.python_batches) == (native_before + 1, python_before)
    for other in (ours.encode_batch_reference(texts, **kw), theirs.encode_batch(texts, **kw)):
        np.testing.assert_array_equal(ids, other[0])
        np.testing.assert_array_equal(mask, other[1])
    return ids, mask


@pytest.mark.parametrize("pad_to", [None, 64])
def test_batch_parity(toks, pad_to):
    texts = CORPUS + ["unseen zzqx words!", "a b c . , ; '"]
    ids, _ = _same(toks, texts, max_seq_length=64, pad_to=pad_to)
    assert ids.shape == (len(texts), 64 if pad_to else 32)


@pytest.mark.parametrize("max_seq_length,pad_to", [(32, 32), (256, 48), (40, None)])
def test_truncation_parity(toks, max_seq_length, pad_to):
    long_text = " ".join(["organic milk"] * 200)
    ids, mask = _same(toks, [long_text, "milk"], max_seq_length=max_seq_length, pad_to=pad_to)
    assert ids[0, mask[0].sum() - 1] == toks[0].sep_id
    assert mask[0].sum() == ids.shape[1]


def test_batch_row_padding(toks):
    ours, _ = toks
    ids, mask = _same(toks, ["milk"], pad_batch_to=4, pad_to=16)
    assert ids.shape == (4, 16)
    assert mask[1:].sum() == 0 and (ids[1:] == ours.pad_id).all()
    with pytest.raises(ValueError, match="pad_batch_to"):
        ours.encode_batch(["a", "b"], pad_batch_to=1)


def test_unicode_handled_natively(toks):
    ours, _ = toks
    texts = ["café au lait", "中文分词", "ＦＵＬＬ ｗｉｄｔｈ！", "emoji 🛒 cart", "ß İstanbul"]
    _, _, _, bailed = ours._get_native().encode_batch(texts, 32, len(texts), ours.pad_id)
    assert bailed.sum() == 0
    before = ours.bailed_rows
    _same(toks, texts, max_seq_length=32)
    assert ours.bailed_rows == before


def test_context_sensitive_rows_bail_to_python(toks):
    # Decomposed combining marks are context-sensitive under NFC: the native
    # path hands those rows back, and the batch still equals Python's.
    ours, _ = toks
    texts = ["cafe\u0301 decomposed", "milk", "mark\u0301s"]
    _, _, _, bailed = ours._get_native().encode_batch(texts, 32, len(texts), ours.pad_id)
    assert bailed.tolist() == [1, 0, 1]
    before = ours.bailed_rows
    _same(toks, texts, max_seq_length=32)
    assert ours.bailed_rows == before + 2


def test_nul_and_control_chars(toks):
    _same(toks, ["ctrl\x07milk\x00shake", "a\x00b", "\x00"], max_seq_length=32)


def test_unicode_fuzz_parity(toks):
    rng = random.Random(7)
    pool = (
        list(range(0x20, 0x250))
        + list(range(0x370, 0x450))
        + [0x4E00 + i for i in range(40)]
        + [0x1F600 + i for i in range(20)]
        + [0x2000 + i for i in range(0x30)]
        + [0xFF00 + i for i in range(0x40)]
        + [0x0301, 0x2028, 0xFE0F, 0x10400]
    )
    texts = [
        "".join(chr(rng.choice(pool)) for _ in range(rng.randint(1, 40))) for _ in range(120)
    ]
    _same(toks, texts, max_seq_length=48)
    assert toks[0].bailed_rows > 0  # the pool holds context-sensitive codepoints


def test_python_route_where_native_cannot_take_the_input(toks):
    ours, _ = toks
    # Text that is not valid UTF-8 (a lone surrogate): the batch takes the
    # Python path, counted as such.
    texts = ["milk \ud800 bread", "milk"]
    before = (ours.native_batches, ours.python_batches)
    ids, mask = ours.encode_batch(texts, max_seq_length=32)
    assert (ours.native_batches, ours.python_batches) == (before[0], before[1] + 1)
    ref = ours.encode_batch_reference(texts, max_seq_length=32)
    np.testing.assert_array_equal(ids, ref[0])
    np.testing.assert_array_equal(mask, ref[1])
    # Vocab ids that are not 0..n-1: the native code cannot index them.
    gappy = {tok: (i if i < 5 else i + 1) for tok, i in ours.vocab.items()}
    tok = WordPieceTokenizer(gappy)
    ids, _ = tok.encode_batch(CORPUS, max_seq_length=32)
    assert (tok.native_batches, tok.python_batches) == (0, 1)
    np.testing.assert_array_equal(ids, tok.encode_batch_reference(CORPUS, max_seq_length=32)[0])


def test_concurrent_encode_batch_shared_handle(toks):
    """One native handle used from many threads at once: ctypes releases
    the GIL during the encode, and the handle's word memo is shared state.
    Every thread gets a serial encode's rows, and the counters lose no
    batch."""
    ours, _ = toks
    rng = np.random.default_rng(7)
    words = [
        "organic", "milk", "bread", "wheat", "aisle", "department", "dairy",
        "unseenzzqx", "mixed42tokens", "upper", "lower", "banana", "yogurt",
    ]
    texts = [
        " ".join(rng.choice(words, size=rng.integers(2, 12)).tolist())
        + f" {int(rng.integers(0, 99999))}"
        for _ in range(400)
    ]
    expected_ids, expected_mask = ours.encode_batch_reference(texts, max_seq_length=48, pad_to=48)

    def worker(seed: int):
        order = np.random.default_rng(seed).permutation(len(texts))
        ids, mask = ours.encode_batch([texts[i] for i in order], max_seq_length=48, pad_to=48)
        return order, ids, mask

    before = ours.native_batches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as ex:
            for order, ids, mask in ex.map(worker, range(16), timeout=120):
                np.testing.assert_array_equal(ids, expected_ids[order])
                np.testing.assert_array_equal(mask, expected_mask[order])
    finally:
        sys.setswitchinterval(interval)
    assert ours.native_batches == before + 16


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two fresh processes, one empty build directory: one compiles while
    the other waits on the lock; both load the same library and encode."""
    script = textwrap.dedent(
        """
        import sys
        from pathlib import Path
        from instacart_next_order_recommendation_tpu_torch.tokenizer import native
        from instacart_next_order_recommendation_tpu_torch.tokenizer import unicode_tables
        from instacart_next_order_recommendation_tpu_torch.tokenizer import WordPieceTokenizer
        native.BUILD_DIR = unicode_tables.CACHE_DIR = Path(sys.argv[1])
        tok = WordPieceTokenizer.train(["organic milk", "wheat bread"], vocab_size=200,
                                       min_frequency=1)
        ids, _ = tok.encode_batch(["organic milk bread"], max_seq_length=16)
        assert tok.native_batches == 1, tok.python_batches
        print(native.library_path().name, ids.tolist())
        """
    )
    build_dir = tmp_path / "native"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(build_dir)], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert outs[0][0] == outs[1][0]
    lib = build_dir / outs[0][0].split()[0]
    assert lib.exists() and lib.with_suffix(".log").exists()
    assert not list(build_dir.glob("*.tmp"))


@pytest.mark.parametrize("compiler,match", [("no-such-compiler-xyz", "cannot run"),
                                             ("false", "exit 1")])
def test_failed_build_raises(tmp_path, monkeypatch, compiler, match):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "COMPILER", compiler)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=match):
        native.load_library()
    tok = WordPieceTokenizer.train(CORPUS, vocab_size=300, min_frequency=1)
    with pytest.raises(RuntimeError, match=match):
        tok.encode_batch(CORPUS)
    assert not native.library_path().exists()


def test_counters_exact_under_threads(toks):
    """The route counters are read-modify-writes shared by threads."""
    ours, _ = toks
    before = ours.native_batches
    barrier = threading.Barrier(6, timeout=60)

    def worker():
        barrier.wait()
        for _ in range(50):
            ours.encode_batch(["milk"], max_seq_length=16)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ours.native_batches == before + 300


@pytest.mark.parametrize("lowercase", [True, False])
def test_basic_tokenize_ascii_pass_equals_the_jax_loop(lowercase):
    """ASCII text takes a regex pass in the port's ``basic_tokenize``: the
    same tokens as the JAX package's character loop over every ASCII code
    (controls that join words, tab/newline/CR that split them, DEL, NUL,
    each punctuation mark), and non-ASCII text still takes the loop."""
    from instacart_next_order_recommendation_tpu.tokenizer.wordpiece import (
        basic_tokenize as jax_basic_tokenize,
    )
    from instacart_next_order_recommendation_tpu_torch.tokenizer.wordpiece import (
        basic_tokenize,
    )

    rng = random.Random(7)
    alphabet = [chr(c) for c in range(128)] + list("aaaaeeeZz09 ,.-")
    texts = ["".join(rng.choice(alphabet) for _ in range(rng.randrange(40)))
             for _ in range(4000)]
    texts += CORPUS + ["ab\x01cd\x0bef\x7fgh", "x\ty\nz\rw", "\x00", "", "Café naïve",
                       "中文 text with spaces"]
    for text in texts:
        assert basic_tokenize(text, lowercase) == jax_basic_tokenize(text, lowercase), repr(text)
