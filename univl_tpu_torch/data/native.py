"""ctypes bindings of the port's native WordPiece tokenizer,
``univl_tpu_torch/csrc/wordpiece.cc`` (the port's ``univl_tpu/data/native.py``).

The source is compiled by the host's C++ compiler (``g++ -O3 -shared -fPIC
-std=c++17``) at first use into ``build/univl_tpu_torch/`` at the root of the
checkout, named by a hash of the source, as ``kernels/_build.py`` builds the
CUDA kernels: a per-process temporary name renamed into place, under a file
lock beside the library, so concurrent first uses (the data-parallel ranks,
the batcher's threads) build it once. A build that fails raises with the
compiler's message; the tokenizer never quietly loses its native path.

The C++ tokenizer takes its Unicode semantics from a table blob built here
from the port's own ``data/tokenization.py`` (Python's ``unicodedata`` is the
source of truth, so both paths agree by construction) and cached in the same
directory. Per codepoint (0 .. TABLE_MAX):
  flags byte: 1 whitespace (with Zl/Zp, which str.split treats as
    separators), 2 drop (NUL, U+FFFD, control), 4 punctuation, 8 CJK,
    16 needs Python (context-sensitive lowercasing, the final sigma, or a
    non-Mn combining character whose canonical reordering could cross
    characters: the C++ path rejects the string);
  mapping: the lower() -> NFD -> strip-Mn output used with do_lower_case
    (offset -1: the identity).
A string the C++ path rejects (-1: such a codepoint, invalid UTF-8, an
embedded NUL, more tokens than the buffer) is tokenized by the Python path,
which gives the ids the C++ path would have: the JAX package's semantics.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import threading
import unicodedata
from typing import List, Optional, Sequence

from univl_tpu_torch.kernels._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "wordpiece.cc")
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
TABLE_MAX = 0x30000  # the BMP and every CJK extension range the algorithm names
TABLE_VERSION = 1

_lock = threading.Lock()
_lib = None


def build_unicode_blob() -> bytes:
    """The Unicode tables (layout in the module's docstring), from the port's
    Python tokenizer's own predicates."""
    from univl_tpu_torch.data import tokenization as T

    flags = bytearray(TABLE_MAX)
    map_off = []
    map_len = bytearray(TABLE_MAX)
    pool: List[int] = []
    for cp in range(TABLE_MAX):
        ch = chr(cp)
        f = 0
        if T._is_whitespace(ch) or (ch.isspace() and not T._is_control(ch)):
            f |= 1
        if cp == 0 or cp == 0xFFFD or T._is_control(ch):
            f |= 2
        if T._is_punctuation(ch):
            f |= 4
        if T._is_cjk(cp):
            f |= 8
        if cp == 0x03A3:  # capital sigma: str.lower() is context-sensitive
            f |= 16
        if unicodedata.combining(ch) != 0 and unicodedata.category(ch) != "Mn":
            f |= 16  # a non-Mn combiner: NFD reordering may cross characters
        out = [ord(c) for c in unicodedata.normalize("NFD", ch.lower())
               if unicodedata.category(c) != "Mn"]
        if any(o >= TABLE_MAX for o in out):
            f |= 16  # the mapping leaves the table
        flags[cp] = f
        if out == [cp]:
            map_off.append(-1)
        else:
            out = out[:255]
            map_off.append(len(pool))
            map_len[cp] = len(out)
            pool.extend(out)
    head = struct.pack("<IIII", 0x55544B31, TABLE_VERSION, TABLE_MAX, len(pool))
    return (head + bytes(flags) + struct.pack(f"<{len(map_off)}i", *map_off) + bytes(map_len)
            + struct.pack(f"<{len(pool)}I", *pool))


def unicode_blob() -> bytes:
    """The tables, built once a Unicode version and cached in ``BUILD_DIR``."""
    path = os.path.join(BUILD_DIR, f"unicode-{TABLE_VERSION}-{unicodedata.unidata_version}.bin")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return f.read()
    blob = build_unicode_blob()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return blob


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"wordpiece-{tag}.so")


def build() -> str:
    """Compile the source unless a library for it exists; return its path.
    One process at a time builds (a lock on ``<library>.lock``)."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):  # another process built it while this one waited
                tmp = f"{path}.tmp{os.getpid()}"
                try:
                    done = subprocess.run([CXX, *CXX_FLAGS, SOURCE, "-o", tmp],
                                          capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"native tokenizer: cannot run {CXX}: {e}") from e
                if done.returncode != 0:
                    raise RuntimeError(f"native tokenizer: {CXX} failed ({done.returncode}):\n"
                                       f"{done.stderr}")
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def compiler_version() -> str:
    """The first line of ``CXX --version``."""
    done = subprocess.run([CXX, "--version"], capture_output=True, text=True, check=True)
    return done.stdout.splitlines()[0]


def load_library() -> ctypes.CDLL:
    """The tokenizer's library, built on first call and cached for the process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.wp_create_utf8.restype = p
            lib.wp_create_utf8.argtypes = [ctypes.c_char_p, i, ctypes.c_char_p, ctypes.c_int64]
            lib.wp_set_never_split.restype = None
            lib.wp_set_never_split.argtypes = [p, ctypes.c_char_p]
            lib.wp_free.restype = None
            lib.wp_free.argtypes = [p]
            lib.wp_tokenize.restype = i
            lib.wp_tokenize.argtypes = [p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), i]
            _lib = lib
        return _lib


class NativeWordPiece:
    """A handle on the C++ tokenizer over ``vocab_tokens`` (in id order).
    ``tokenize_ids`` returns None where the text needs the Python path.

    Thread-safe: the handle is immutable after construction and each thread
    has its own output buffer (the batcher tokenizes from a thread pool)."""

    MAX_TOKENS = 4096

    def __init__(self, vocab_tokens: Sequence[str], do_lower_case: bool = True,
                 never_split: Optional[Sequence[str]] = None):
        lib = load_library()
        tables = unicode_blob()
        handle = lib.wp_create_utf8("\n".join(vocab_tokens).encode("utf-8"),
                                    int(do_lower_case), tables, len(tables))
        if not handle:
            raise RuntimeError("native tokenizer: the C++ side refused the Unicode tables")
        if never_split is not None:
            # the Python tokenizer's set, so the two paths never diverge
            lib.wp_set_never_split(handle, "\n".join(never_split).encode("utf-8"))
        self._lib, self._handle = lib, handle
        self._tls = threading.local()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.wp_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def tokenize_ids(self, text: str) -> Optional[List[int]]:
        try:
            raw = text.encode("utf-8")
        except UnicodeEncodeError:  # a lone surrogate: the Python path
            return None
        if b"\x00" in raw:
            # a c_char_p ends at the NUL, where the Python path drops the
            # control character and goes on: the Python path
            return None
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = (ctypes.c_int32 * self.MAX_TOKENS)()
        n = self._lib.wp_tokenize(self._handle, raw, buf, self.MAX_TOKENS)
        return None if n < 0 else list(buf[:n])
