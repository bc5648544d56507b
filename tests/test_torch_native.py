"""The port's native WordPiece tokenizer (``univl_tpu_torch/data/native.py``
over its copy of ``csrc/wordpiece.cc``, built with the host's g++) against
the JAX package's ``NativeWordPiece`` and against the port's Python path:
the same ids on the YouCook2 and MSRVTT fixture captions and transcripts, on
ASCII, Unicode and never-split text, with and without ``do_lower_case``; the
Unicode tables byte for byte JAX's; ``UNIVL_TPU_NO_NATIVE`` turns the path
off; a build that fails raises."""

import json
import pickle
from concurrent.futures import ThreadPoolExecutor

import pytest

from univl_tpu.data import native as jax_native
from univl_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from univl_tpu_torch.data import fixtures, native
from univl_tpu_torch.data.tokenization import WordPieceTokenizer

ASCII = [
    "Add the chopped onions, then STIR well!", "heat some olive oil in a pan",
    "a" * 150, "mix   flour\tand water\n", "salt... pepper?! (garlic)", "", "   ",
    "add-the-onions", "123 mix 45x", "zzz unknownword qqq",
]
NEVER_SPLIT = [
    "hello [UNK] world", "add [SEP] salt", "[CLS] mix [MASK] stir [SEP]", "a [MASK]!",
    "[SEP]x", "[PAD] is protected", "x\t[SEP]\ny",
]
UNICODE = [
    "café olé", "添加洋葱 then stir", "naïve mix", "ÜBER Äpfel", "İstanbul", "ЖИЗНЬ хорошо",
    "crème brûlée!", "ñoño 한국어", "ＦＵＬＬＷＩＤＴＨ text", "[SEP] café [UNK]", "𝔘𝔫𝔦𝔠𝔬𝔡𝔢",
    "em—dash and … ellipsis", "«guillemets»",
]
DECLINED = ["ΣΟΦΟΣ σοφος", "beyond \U00030001 table", "lone \ud800 surrogate", "add\x00salt"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(the vocab, every caption and transcript of the YouCook2 and MSRVTT
    fixtures)."""
    d = tmp_path_factory.mktemp("native")
    _, data, _ = fixtures.make_youcook(str(d / "youcook"), n_videos=8, clips_per_video=4)
    _, _, js, _ = fixtures.make_msrvtt(str(d / "msrvtt"), n_videos=8, sentences_per_video=5)
    with open(data, "rb") as f:
        texts = [str(t) for v in pickle.load(f).values() for k in ("text", "transcript")
                 for t in v[k]]
    with open(js) as f:
        texts += [s["caption"] for s in json.load(f)["sentences"]]
    return fixtures.make_vocab(str(d / "vocab.txt")), texts


def _python(vocab, monkeypatch, **kw):
    monkeypatch.setenv("UNIVL_TPU_NO_NATIVE", "1")
    tok = WordPieceTokenizer(vocab, **kw)
    monkeypatch.delenv("UNIVL_TPU_NO_NATIVE")
    return tok


@pytest.mark.parametrize("lower", [True, False], ids=["lower", "cased"])
def test_ids_match_jax_native_and_python(files, monkeypatch, lower):
    """Every text through the port's native path, JAX's ``NativeWordPiece``
    (its own build) and the port's Python path: the same ids."""
    vocab, texts = files
    tok = WordPieceTokenizer(vocab, do_lower_case=lower)
    assert tok.native
    jax_tok = JaxTokenizer(vocab, do_lower_case=lower)
    assert jax_tok._native is not None, "the JAX package's native path did not build"
    py = _python(vocab, monkeypatch, do_lower_case=lower)
    assert not py.native
    for text in texts + ASCII + NEVER_SPLIT + UNICODE:
        ids = tok._native.tokenize_ids(text)
        assert ids == jax_tok._native.tokenize_ids(text), text
        got = tok.convert_tokens_to_ids(tok.tokenize(text))
        assert got == py.convert_tokens_to_ids(py.tokenize(text)), text
        assert got == jax_tok.convert_tokens_to_ids(jax_tok.tokenize(text)), text
        if ids is not None:
            assert got == ids, text


def test_declined_text_takes_the_python_path(files, monkeypatch):
    """Text the C++ path declines (-1: the context-sensitive sigma, a
    codepoint beyond the tables, a lone surrogate, an embedded NUL) gets the
    Python path's tokens."""
    vocab, _ = files
    tok, py = WordPieceTokenizer(vocab), _python(vocab, monkeypatch)
    for text in DECLINED:
        assert tok._native.tokenize_ids(text) is None, ascii(text)
        assert tok.tokenize(text) == py.tokenize(text), ascii(text)


def test_custom_never_split_reaches_the_native_path(files, monkeypatch):
    vocab, _ = files
    tok = WordPieceTokenizer(vocab, never_split=("[UNK]",))
    got = tok.tokenize("add [SEP] salt")
    assert "[SEP]" not in got and "[SEP]" in WordPieceTokenizer(vocab).tokenize("add [SEP] salt")
    assert got == _python(vocab, monkeypatch, never_split=("[UNK]",)).tokenize("add [SEP] salt")


def test_unicode_tables_are_jax_byte_for_byte():
    assert native.build_unicode_blob() == jax_native._build_unicode_blob()


def test_switch_turns_the_native_path_off(files, monkeypatch):
    vocab, texts = files
    monkeypatch.setenv("UNIVL_TPU_NO_NATIVE", "1")
    tok = WordPieceTokenizer(vocab)
    assert not tok.native and tok._native is None
    assert tok.tokenize(texts[0])


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_build_raises(files, monkeypatch, tmp_path, fault):
    """A compiler that is not there, or a source it refuses: the tokenizer
    raises with the compiler's message, never falls back unnoticed."""
    vocab, _ = files
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    if fault == "no_compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        want = "cannot run"
    else:
        bad = tmp_path / "wordpiece.cc"
        bad.write_text("int broken( {\n")
        monkeypatch.setattr(native, "SOURCE", str(bad))
        want = "error"
    with pytest.raises(RuntimeError, match=want):
        WordPieceTokenizer(vocab)


def test_threads_share_one_handle(files, monkeypatch):
    """The batcher tokenizes from a thread pool: each thread its own buffer."""
    vocab, texts = files
    tok, py = WordPieceTokenizer(vocab), _python(vocab, monkeypatch)
    want = [py.tokenize(t) for t in texts]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(5):
            assert list(pool.map(tok.tokenize, texts)) == want
