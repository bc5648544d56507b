"""UniVL in PyTorch with hand-written CUDA kernels for an NVIDIA H100.

A port of ``univl_tpu`` (JAX/Flax/Pallas), which stays beside it as the
reference. This package imports ``torch`` and never ``jax``, and nothing
of ``univl_tpu``: where it needs a part of that package that is free of JAX
(the configuration, the tokenizer, the text and video padding, the data
readers and fixtures, the argument parsers), it keeps its own copy under the
same module name.

Layout:
    config.py    the configuration dataclasses
    data/        the tokenizer, text and video padding; youcook.py (the
                 YouCook2 retrieval dataset), batching.py (the seeded
                 batcher), fixtures.py (synthetic data in the reference's
                 file formats)
    kernels/     CUDA kernels (csrc/*.cu, built at first use) and their
                 plain PyTorch versions
    nn/          encoder blocks (with their training mode: dropout and the
                 training-attention kernels), the text, visual and cross
                 towers, the caption decoder
    models/      UniVL: serving, and the FT-Joint training forward;
                 losses.py (the max-margin ranking loss)
    train/       BertAdam with UniVL's parameter groups; the single-device
                 trainer with gradient accumulation
    checkpoint/  weights from a JAX tree, a reference .bin, or a seeded init;
                 the JAX path of each parameter
    evals/       beam search over the KV-cache decoder
    serving/     the retrieval index, the caption service and its coalescer
    utils/       the host-side step timer
    cli/         the server (retrieval, caption, or both) and
                 task_retrieval.py (FT-Joint training)
"""

from univl_tpu_torch.config import UniVLConfig
from univl_tpu_torch.data.tokenization import WordPieceTokenizer

__all__ = ["UniVLConfig", "WordPieceTokenizer"]
