"""The defaults of ``--fused_decode`` and ``--fused_vocab``: unset, the
caption eval of ``univl_tpu_torch.cli.task_caption`` decodes without the
fused kernels on every device, as JAX's ``task_caption`` eval does
(``univl_tpu/cli/task_caption.py:81-86``), while the caption server takes
them on a CUDA device. No card is needed: the eval's generator is replaced
by one that records its arguments.
"""

import logging
from types import SimpleNamespace

import pytest
import torch

from univl_tpu_torch.cli import task_caption
from univl_tpu_torch.serving.captioning import resolve_fused


class _Built(Exception):
    pass


def _eval_flags(monkeypatch, tmp_path, device, fused_decode=None, fused_vocab=None):
    """The fused flags make_eval_fn's eval hands its caption generator."""
    seen = {}

    def generator(model, tokenizer, dev, **kw):
        seen.update(kw, device=dev)
        raise _Built

    monkeypatch.setattr(task_caption, "CaptionGenerator", generator)
    args = SimpleNamespace(batch_size_val=4, num_thread_reader=0, max_words=16,
                           fused_decode=fused_decode, fused_vocab=fused_vocab, fused_cls=False,
                           no_prefetch=True, output_dir=str(tmp_path))
    model = torch.nn.Linear(1, 1)
    eval_fn = task_caption.make_eval_fn(args, model, None, device, [], logging.getLogger())
    with pytest.raises(_Built):
        eval_fn()
    return seen


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_caption_eval_leaves_the_fused_kernels_off_unless_given(monkeypatch, tmp_path, device):
    seen = _eval_flags(monkeypatch, tmp_path, torch.device(device))
    assert seen["device"] == torch.device(device)
    assert seen["fused_decode"] is False and seen["fused_vocab"] is False


@pytest.mark.parametrize("given", [True, False])
def test_caption_eval_takes_the_fused_flags_as_given(monkeypatch, tmp_path, given):
    seen = _eval_flags(monkeypatch, tmp_path, torch.device("cuda"), given, given)
    assert seen["fused_decode"] is given and seen["fused_vocab"] is given


def test_server_keeps_the_fused_kernels_on_a_cuda_device():
    assert resolve_fused(None, torch.device("cuda")) is True
    assert resolve_fused(None, torch.device("cpu")) is False
    assert resolve_fused(False, torch.device("cuda")) is False
    assert resolve_fused(True, torch.device("cpu")) is True
