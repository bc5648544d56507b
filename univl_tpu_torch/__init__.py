"""UniVL in PyTorch with hand-written CUDA kernels for an NVIDIA H100.

A port of ``univl_tpu`` (JAX/Flax/Pallas), which stays beside it as the
reference. This package imports ``torch`` and never ``jax``; the parts of
``univl_tpu`` that are free of JAX (the configuration, the tokenizer, the
text and video padding, the serve argument parser) are shared by import.

Layout:
    kernels/     CUDA kernels (csrc/*.cu, built at first use) and their
                 plain PyTorch versions
    nn/          encoder blocks and the text, visual and cross towers
    models/      UniVL's retrieval subset
    checkpoint/  weights from a JAX tree, a reference .bin, or a seeded init
    serving/     the retrieval index
    cli/         the retrieval server
"""

from univl_tpu.config import UniVLConfig
from univl_tpu.data.tokenization import WordPieceTokenizer

__all__ = ["UniVLConfig", "WordPieceTokenizer"]
