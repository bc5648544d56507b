"""The port's four command lines against JAX's: every option of JAX's parser
for a CLI (``univl_tpu/cli/common.py:base_parser``, plus ``add_pretrain_args``
and ``add_serve_args``) is taken by the port's parser of that CLI with the
same action, default and type, but the out-of-scope ones: ``--scan_layers``
and the TPU-only ``--use_pallas``, ``--attention`` and ``--train_attention``,
which the port refuses as unknown, and ``--fused_ffn``'s ``auto`` and
``auto_block``, which it refuses with the reason. Then the flags' meaning
where the CLIs differ: ``task_retrieval`` refuses a ``--task_type`` other than
``retrieval`` (JAX asserts it), ``task_caption`` sets ``caption``, pretraining
and the server take ``--do_eval`` and ``--task_type`` and ignore them, the
server's ``--do_pretrain`` reaches the config as JAX's does, and the task CLIs
still refuse ``--do_pretrain``. Parses only: nothing is compiled or run.
"""

import argparse
import dataclasses

import pytest
import torch

from univl_tpu.cli import common as jax_common
from univl_tpu.cli.pretrain import add_pretrain_args as jax_pretrain_args
from univl_tpu.cli.serve import add_serve_args as jax_serve_args
from univl_tpu_torch.cli import common, pretrain, serve, task_caption, task_retrieval

OUT_OF_SCOPE = ("--scan_layers", "--use_pallas", "--attention", "--train_attention")
FUSED_FFN_OUT_OF_SCOPE = {"auto", "auto_block"}
UNUSED = ["--lr_decay", "0.9", "--fp16_opt_level", "O1", "--local_rank", "0", "--world_size",
          "0"]

JAX_PARSERS = {
    "task_retrieval": lambda: jax_common.base_parser("retrieval"),
    "task_caption": lambda: jax_common.base_parser("caption"),
    "pretrain": lambda: jax_pretrain_args(jax_common.base_parser("pretrain")),
    "serve": lambda: jax_serve_args(jax_common.base_parser("serve")),
}
PORT = {"task_retrieval": task_retrieval, "task_caption": task_caption, "pretrain": pretrain,
        "serve": serve}


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.option_strings[0] != "-h"}


CASES = [(cli, flag) for cli, make in JAX_PARSERS.items() for flag in sorted(_options(make()))]


def _required(cli: str, tmp_path) -> list:
    """The arguments each port CLI needs to parse at all."""
    argv = ["--output_dir", str(tmp_path), "--vocab_file", str(tmp_path / "vocab.txt")]
    if cli in ("task_retrieval", "task_caption", "pretrain"):
        argv += ["--device", "cpu"]
    if cli in ("task_retrieval", "task_caption"):
        argv += ["--do_train"]
    return argv


def _parse(cli: str, argv: list):
    """The port CLI's args, as its ``main`` parses them (the server's parser
    has no checks after the parse)."""
    if cli == "serve":
        return serve.build_parser().parse_args(argv)
    return PORT[cli].parse_args(argv)


@pytest.mark.parametrize("cli,flag", CASES, ids=[f"{c}{f}" for c, f in CASES])
def test_port_takes_jax_option(cli, flag, capsys):
    """The port's parser takes JAX's option with its action, default, type
    and choices; an out-of-scope one is refused as unknown, and
    ``--fused_ffn``'s out-of-scope choices with the reason."""
    want = _options(JAX_PARSERS[cli]())[flag]
    port = _options(PORT[cli].build_parser())
    if flag in OUT_OF_SCOPE:
        assert flag not in port
        with pytest.raises(SystemExit) as e:
            PORT[cli].build_parser().parse_args(["--output_dir", "o", flag])
        assert e.value.code == 2 and f"unrecognized arguments: {flag}" in capsys.readouterr().err
        return
    got = port[flag]
    assert type(got) is type(want) and got.default == want.default and got.dest == want.dest
    assert got.nargs == want.nargs and got.required == want.required
    if flag == "--fused_ffn":
        assert set(want.choices) - set(got.choices) == FUSED_FFN_OUT_OF_SCOPE
        assert set(got.choices) < set(want.choices)
        for value in FUSED_FFN_OUT_OF_SCOPE:
            with pytest.raises(argparse.ArgumentTypeError, match="choose xla, pallas or block"):
                got.type(value)
        assert all(got.type(v) == v for v in got.choices)
    else:
        assert got.type == want.type and got.choices == want.choices


@pytest.mark.parametrize("cli", list(PORT))
def test_flags_jax_parses_and_ignores(cli, tmp_path):
    """``--lr_decay 0.9 --fp16_opt_level O1 --local_rank 0 --world_size 0``
    (the reference's launcher passes ``--local_rank``) parse in every CLI,
    at JAX's values, and ``--profile_dir`` with them."""
    args = _parse(cli, _required(cli, tmp_path) + UNUSED + ["--profile_dir", str(tmp_path)])
    assert (args.lr_decay, args.fp16_opt_level, args.local_rank, args.world_size) == (
        0.9, "O1", 0, 0)
    assert args.profile_dir == str(tmp_path)


def test_task_retrieval_refuses_another_task_type(tmp_path, capsys):
    """JAX's ``task_retrieval`` asserts ``--task_type retrieval``
    (``univl_tpu/cli/task_retrieval.py:71``): the port refuses another
    value at parse, naming the flag, and takes ``retrieval`` with
    ``--do_eval``."""
    argv = _required("task_retrieval", tmp_path)
    with pytest.raises(SystemExit) as e:
        task_retrieval.parse_args(argv + ["--task_type", "caption"])
    assert e.value.code == 2 and "--task_type caption" in capsys.readouterr().err
    args = task_retrieval.parse_args(argv + ["--do_eval", "--task_type", "retrieval"])
    assert args.task_type == "retrieval" and args.do_eval


def test_task_caption_sets_caption(tmp_path):
    """JAX's ``task_caption`` sets ``task_type = "caption"`` whatever was
    given (``univl_tpu/cli/task_caption.py:54``)."""
    argv = _required("task_caption", tmp_path)
    assert task_caption.parse_args(argv + ["--task_type", "retrieval"]).task_type == "caption"
    assert task_caption.parse_args(argv).task_type == "caption"


@pytest.mark.parametrize("cli", ["pretrain", "serve"])
def test_do_eval_and_task_type_ignored(cli, tmp_path):
    """Pretraining and the server take ``--do_eval`` and ``--task_type`` as
    JAX's do, and build their config with their mode's own task type."""
    args = _parse(cli, _required(cli, tmp_path) + ["--do_eval", "--task_type", "caption"])
    assert args.do_eval and args.task_type == "caption"


@pytest.mark.parametrize("cli", ["task_retrieval", "task_caption"])
def test_task_clis_still_refuse_do_pretrain(cli, tmp_path, capsys):
    """``--do_pretrain`` is in the shared parser now; the task CLIs still
    refuse it after the parse, naming pretraining's entry point."""
    with pytest.raises(SystemExit) as e:
        PORT[cli].parse_args(_required(cli, tmp_path) + ["--do_pretrain"])
    assert e.value.code == 2 and "univl_tpu_torch.cli.pretrain" in capsys.readouterr().err


def _flat(obj, prefix: str = "") -> dict:
    out = {}
    for k, v in obj.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mode", ["retrieval", "caption"])
def test_serve_do_pretrain_reaches_the_config(mode, tmp_path):
    """``serve --do_pretrain``: the port's ``build_config`` equals JAX's on
    every field both configs have (JAX on its CPU backend, the port on the
    CPU), ``do_pretrain`` set in both; the task type the mode's."""
    argv = ["--output_dir", str(tmp_path), "--vocab_file", "vocab.txt", "--do_pretrain",
            "--mode", mode, "--n_gpu", "1", "--task_type", "retrieval"]
    task_type = "caption" if mode == "caption" else "retrieval"
    jax_args = JAX_PARSERS["serve"]().parse_args(argv)
    port_args = serve.build_parser().parse_args(argv)
    want = _flat(dataclasses.asdict(jax_common.build_config(jax_args, task_type=task_type)))
    got = _flat(dataclasses.asdict(common.build_config(port_args, torch.device("cpu"),
                                                       task_type=task_type)))
    shared = set(want) & set(got)
    assert len(shared) > 50 and want["do_pretrain"] is got["do_pretrain"] is True
    assert got["task_type"] == task_type
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
