"""Local artifact resolution and cache, the port's copy of
``univl_tpu/utils/file_utils.py`` (the reference's modules/file_utils.py).

Nothing here touches the network: ``http``, ``https`` and ``s3`` URLs
raise. Plain paths pass through, ``file://`` URLs resolve, and ``.tar.gz``,
``.tgz`` and ``.tar`` archives are extracted into the cache once, keyed by
their first MiB and their size (the reference untars bert-base-uncased.tar.gz
the same way).
"""

from __future__ import annotations

import hashlib
import os
import tarfile
from typing import Optional
from urllib.parse import urlparse

CACHE_DIR = os.environ.get("UNIVL_TPU_CACHE",
                           os.path.expanduser("~/.cache/univl_tpu/artifacts"))
ARCHIVES = (".tar.gz", ".tgz", ".tar")


def cached_path(path_or_url: str, cache_dir: Optional[str] = None) -> str:
    """The local path of ``path_or_url``: the file itself, or the directory
    its archive was extracted into."""
    cache_dir = cache_dir or CACHE_DIR
    parsed = urlparse(path_or_url)
    if parsed.scheme in ("http", "https", "s3"):
        raise OSError(f"cached_path: remote fetch disabled (zero-egress deployment): "
                      f"{path_or_url}. Fetch the artifact out of band and pass its local path "
                      f"(or place it under UNIVL_TPU_CACHE).")
    path = parsed.path if parsed.scheme == "file" else path_or_url
    if not os.path.exists(path):
        raise FileNotFoundError(f"cached_path: {path} not found")
    if not path.endswith(ARCHIVES):
        return path
    # the first MiB and the size: two archives with one prefix but different
    # contents after it do not share an extraction
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
    h.update(str(os.stat(path).st_size).encode())
    out = os.path.join(cache_dir, f"extracted-{h.hexdigest()[:16]}")
    done = os.path.join(out, ".done")
    if not os.path.exists(done):
        os.makedirs(out, exist_ok=True)
        with tarfile.open(path) as tar:
            tar.extractall(out, filter="data")
        with open(done, "w") as f:
            f.write(path)
    return out
