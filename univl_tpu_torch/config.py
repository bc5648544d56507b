"""Configuration dataclasses, the port's own copy of ``univl_tpu/config.py``.

The same fields, defaults and constructors (``base()``, ``tiny()``,
``replace()``, ``validate()``, the encoder configs' ``from_json``), so ``dataclasses.asdict`` of a port config
equals the JAX package's for the same arguments. Knobs that only the TPU
package reads (``use_pallas``, ``scan_layers``, ...) are kept so the two
stay comparable field for field; the port ignores them. The port reads
``use_fused_ffn`` (False, True or "block": the FFN kernels #3, or #4 and #5)
and refuses JAX's "auto" and "auto_block", whose row thresholds were
measured on the TPU; and ``remat`` (False, True or "dots").
"""

from __future__ import annotations

import dataclasses
import json


FUSED_FFN_ROUTES = (False, True, "block")  # the unfused FFN, kernel #3, kernels #4 and #5
# JAX's "auto" and "auto_block" pick a route by a row count
TPU_THRESHOLD = "its 16,384-row threshold was measured on the TPU and is not carried over"


def check_fused_ffn(route) -> None:
    """Refuse a ``use_fused_ffn`` the port does not run."""
    if route in ("auto", "auto_block"):
        raise ValueError(f"use_fused_ffn={route!r}: {TPU_THRESHOLD}; choose False, True or "
                         f"'block'")
    if route not in FUSED_FFN_ROUTES:
        raise ValueError(f"use_fused_ffn must be False, True or 'block', got {route!r}")


REMAT_MODES = (False, True, "dots")  # none, each tower layer whole, save its weight products


def check_remat(remat) -> None:
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be False, True or 'dots', got {remat!r}")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Hyperparameters shared by the text, visual and cross towers."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    @classmethod
    def from_json(cls, path: str, **overrides):
        """A reference ``<kind>_config.json``: the keys this config does not
        have dropped, then ``overrides`` applied (``univl_tpu/config.py:43-50``)."""
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d.update(overrides)
        return cls(**d)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BertConfig(EncoderConfig):
    """Text encoder (BERT-base defaults)."""


@dataclasses.dataclass(frozen=True)
class VisualConfig(EncoderConfig):
    """Visual encoder over S3D features; ``vocab_size`` is the feature dim."""

    vocab_size: int = 1024
    num_hidden_layers: int = 1


@dataclasses.dataclass(frozen=True)
class CrossConfig(EncoderConfig):
    """Fusion encoder over concatenated [text ; video] features."""

    vocab_size: int = 768
    num_hidden_layers: int = 2
    max_position_embeddings: int = 1024


@dataclasses.dataclass(frozen=True)
class DecoderConfig(EncoderConfig):
    """Autoregressive caption decoder."""

    num_decoder_layers: int = 1
    max_target_embeddings: int = 512


@dataclasses.dataclass(frozen=True)
class UniVLConfig:
    """The four module configs plus the task-level knobs."""

    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    visual: VisualConfig = dataclasses.field(default_factory=VisualConfig)
    cross: CrossConfig = dataclasses.field(default_factory=CrossConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)

    max_words: int = 48
    max_frames: int = 48
    video_dim: int = 1024
    margin: float = 0.1
    hard_negative_rate: float = 0.5
    negative_weighting: bool = False
    n_pair: int = 1
    use_mil: bool = False
    sampled_use_mil: bool = False
    stage_two: bool = False
    train_sim_after_cross: bool = False
    do_pretrain: bool = False
    pretrain_enhance_vmodal: bool = False
    task_type: str = "retrieval"  # retrieval | caption
    batch_size_per_device: int = 32

    compute_dtype: str = "float32"  # or "bfloat16"
    # read only by the JAX package (its Pallas and XLA switches), but for
    # use_fused_ffn: False | True | "block", the port's FFN route, and remat
    use_pallas: object = False
    use_train_pallas: object = False
    use_fused_ffn: object = False
    fused_qkv: bool = False
    remat: object = False  # False | True | "dots": the towers' activation checkpointing
    scan_layers: bool = False
    sequence_parallel: bool = False

    def validate(self):
        if not (self.max_words <= self.bert.max_position_embeddings
                and self.max_words <= self.decoder.max_target_embeddings
                and self.max_frames <= self.visual.max_position_embeddings
                and self.max_words + self.max_frames <= self.cross.max_position_embeddings):
            raise ValueError(f"max_words {self.max_words} / max_frames {self.max_frames} "
                             f"exceed the position tables")
        check_fused_ffn(self.use_fused_ffn)
        check_remat(self.remat)
        return self

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def base(
        cls,
        text_num_hidden_layers: int = 12,
        visual_num_hidden_layers: int = 6,
        cross_num_hidden_layers: int = 2,
        decoder_num_hidden_layers: int = 3,
        **kw,
    ) -> "UniVLConfig":
        """The default run configuration (BERT-base widths)."""
        return cls(
            bert=BertConfig(num_hidden_layers=text_num_hidden_layers),
            visual=VisualConfig(num_hidden_layers=visual_num_hidden_layers),
            cross=CrossConfig(num_hidden_layers=cross_num_hidden_layers),
            decoder=DecoderConfig(num_decoder_layers=decoder_num_hidden_layers),
            **kw,
        ).validate()

    @classmethod
    def tiny(cls, **kw) -> "UniVLConfig":
        """Small config for tests: 2-layer towers, hidden 64."""
        enc = dict(
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
        )
        defaults = dict(
            bert=BertConfig(vocab_size=512, **enc),
            visual=VisualConfig(vocab_size=32, **enc),
            cross=CrossConfig(vocab_size=64, max_position_embeddings=1024, **enc),
            decoder=DecoderConfig(
                vocab_size=512,
                num_decoder_layers=2,
                max_target_embeddings=512,
                **enc,
            ),
            max_words=16,
            max_frames=8,
            video_dim=32,
            batch_size_per_device=4,
            use_pallas=False,
        )
        defaults.update(kw)
        return cls(**defaults).validate()
