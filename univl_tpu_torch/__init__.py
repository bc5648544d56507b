"""UniVL in PyTorch with hand-written CUDA kernels for an NVIDIA H100.

A port of ``univl_tpu`` (JAX/Flax/Pallas), which stays beside it as the
reference. This package imports ``torch`` and never ``jax``, and nothing
of ``univl_tpu``: where it needs a part of that package that is free of JAX
(the configuration, the tokenizer, the text and video padding, the serve
argument parser), it keeps its own copy under the same module name.

Layout:
    config.py    the configuration dataclasses
    data/        the tokenizer, text and video padding
    kernels/     CUDA kernels (csrc/*.cu, built at first use) and their
                 plain PyTorch versions
    nn/          encoder blocks, the text, visual and cross towers, the
                 caption decoder
    models/      UniVL's serving subset
    checkpoint/  weights from a JAX tree, a reference .bin, or a seeded init
    evals/       beam search over the KV-cache decoder
    serving/     the retrieval index, the caption service and its coalescer
    cli/         the server (retrieval, caption, or both)
"""

from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.data.tokenization import WordPieceTokenizer

__all__ = ["UniVLConfig", "WordPieceTokenizer"]
