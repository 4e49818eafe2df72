"""The port's command line against usip_tpu's, and ``import-torch``.

The surface test diffs the subcommands and the flags of both argparse trees
against the gap listed here, each entry with its reason; a command or flag
that one side gains or loses outside the list fails it, and later slices
shrink the list. ``import-torch`` turns a reference ``.pth`` into the port's
full-state ``.pt`` with the parameters usip_tpu's ``import-torch`` writes to
its ``.msgpack`` from the same file, and ``train-detector --resume`` trains
on from it.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from usip_tpu import cli as jax_cli
from usip_tpu_torch import cli
from usip_tpu_torch.config import get_config
from usip_tpu_torch.train.checkpoint import (restore_checkpoint,
                                             state_dict_from_msgpack)
from usip_tpu_torch.train.descriptor_loop import init_descriptor_state
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,
                                    seeded_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --------------------------------------------------------- the surface ----

# usip_tpu's commands the port lacks: none
MISSING_COMMANDS = set()
# flags that pick a JAX platform (the port takes --device)
JAX_PLATFORM = {"--platform"}
# usip_tpu's multi-host flags on commands that run on one host
MULTI_HOST = {"--coordinator-address", "--num-processes", "--process-id"}
# usip_tpu's shared run flags (its _add_common) on commands that never
# train: they set config fields these commands do not read
UNREAD_RUN_FLAGS = {"--dataroot", "--batch-size", "--epochs", "--num-devices",
                    "--name", "--checkpoints-dir", "--synthetic",
                    "--profile-dir"}
NOT_TRAINING = JAX_PLATFORM | MULTI_HOST | UNREAD_RUN_FLAGS
MISSING_FLAGS = {
    "detect": NOT_TRAINING,
    # host code over an export tree: it reads --dataroot and --synthetic
    "render-keypoints": NOT_TRAINING - {"--dataroot", "--synthetic"},
    "serve": NOT_TRAINING,
    "export-model": NOT_TRAINING,
    "import-torch": NOT_TRAINING,
    "run-model": JAX_PLATFORM,
    "train-detector": JAX_PLATFORM,
    "train-descriptor": JAX_PLATFORM,
    "export-keypoints": JAX_PLATFORM,
    "export-descriptors": JAX_PLATFORM,
}
# the port's own: its device, the collectives backend of its ranks, and
# train-descriptor's resume (usip_tpu's engine resumes, its command not)
EXTRA_FLAGS = {
    "detect": {"--device"}, "serve": {"--device"}, "bench": {"--device"},
    "run-model": {"--device"},
    "train-detector": {"--device", "--dist-backend"},
    "train-descriptor": {"--device", "--dist-backend", "--resume"},
    "export-keypoints": {"--device", "--dist-backend"},
    "export-descriptors": {"--device", "--dist-backend"},
}


def _flags(parser):
    """``{command: {--flag, ...}}`` of a parser's subcommands."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = {o for a in sub._actions
                             for o in a.option_strings
                             if o.startswith("--")} - {"--help"}
    return out


class _Captured(Exception):
    pass


def _jax_tree(monkeypatch):
    """usip_tpu's parser, as its ``main`` builds it."""
    def capture(self, *args, **kwargs):
        raise _Captured(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured) as caught:
        jax_cli.main([])
    monkeypatch.undo()
    return _flags(caught.value.args[0])


def test_commands_match_usip_tpu_but_the_listed_gap(monkeypatch):
    ref, port = _jax_tree(monkeypatch), _flags(cli.build_parser())
    assert set(ref) - set(port) == MISSING_COMMANDS
    assert set(port) - set(ref) == set()


@pytest.mark.parametrize("command", sorted(
    set(_flags(cli.build_parser()))))
def test_flags_match_usip_tpu_but_the_listed_gap(monkeypatch, command):
    ref, port = _jax_tree(monkeypatch), _flags(cli.build_parser())
    assert ref[command] - port[command] == MISSING_FLAGS.get(command, set())
    assert port[command] - ref[command] == EXTRA_FLAGS.get(command, set())


# ------------------------------------------------------- import-torch ----

TINY = {"data.input_pc_num": 128, "data.node_num": 16, "detector.c1": 16,
        "detector.c2": 32, "detector.node_knn_k": 4,
        "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
        "descriptor.surface_normal_len": 3,
        "detector.compute_dtype": "float32",
        "descriptor.compute_dtype": "float32"}
FLAGS = ["--dataset", "modelnet"] + [
    a for k, v in TINY.items() for a in ("--override", f"{k}={v}")]


def _reference_pth(tmp_path, role):
    """A reference-style ``.pth``: seeded weights under the reference's
    names, the detector's behind ``nn.DataParallel``'s ``module.``."""
    cfg = get_config("modelnet", role=role, **TINY)
    if role == "detector":
        sd = {f"module.{k}": torch.tensor(v) for k, v in
              seeded_state_dict(cfg.detector, 0).items()}
    else:
        sd = {k: torch.tensor(v) for k, v in
              seeded_descriptor_state_dict(cfg.descriptor, 0).items()}
    path = str(tmp_path / f"0_net_{role}.pth")
    torch.save(sd, path)
    return cfg, path


@pytest.mark.parametrize("role", ["detector", "descriptor"])
def test_import_torch_matches_usip_tpu(tmp_path, role):
    """``python -m usip_tpu_torch.cli import-torch`` writes a full-state
    ``.pt`` that restores at step 0 with a fresh Adam, the sidecar
    ``{"imported_from", "role"}``, and parameters and statistics equal to
    those of usip_tpu's ``import-torch`` ``.msgpack`` of the same file."""
    cfg, pth = _reference_pth(tmp_path, role)
    out = str(tmp_path / "imported.pt")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "usip_tpu_torch.cli", "import-torch", "--pth",
         pth, "--out", out, "--role", role, *FLAGS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = str(tmp_path / "imported.msgpack")
    jax_cli.main(["import-torch", "--pth", pth, "--out", ref, "--role", role,
                  *FLAGS])
    state = (init_detector_state(cfg, seed=1) if role == "detector"
             else init_descriptor_state(cfg, seed=1))
    meta = restore_checkpoint(out, state)
    assert meta == {"imported_from": pth, "role": role}
    assert state.step == 0
    assert state.optimizer.state_dict()["state"] == {}
    ref_sd, ref_step = state_dict_from_msgpack(ref)
    assert ref_step == 0
    own = state.model.state_dict()
    assert set(own) == set(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(own[k].float(), v.float()), k


def test_resume_from_imported_checkpoint_trains(tmp_path):
    """``train-detector --resume`` fine-tunes from an imported ``.pt``: one
    epoch on the CPU from step 0, its checkpoints and metrics written."""
    _, pth = _reference_pth(tmp_path, "detector")
    out = str(tmp_path / "imported.pt")
    cli.main(["import-torch", "--pth", pth, "--out", out, *FLAGS])
    ckpts = str(tmp_path / "ckpt")
    cli.main(["train-detector", "--synthetic", "--epochs", "1",
              "--batch-size", "8", "--device", "cpu", "--name", "ft",
              "--checkpoints-dir", ckpts, "--resume", out, *FLAGS])
    with open(os.path.join(ckpts, "ft", "ft_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(np.isfinite(r["loss"]) for r in rows
                        if "loss" in r)
    assert os.path.exists(os.path.join(ckpts, "ft", "last.pt"))
    state = init_detector_state(get_config("modelnet", **TINY), seed=0)
    meta = restore_checkpoint(os.path.join(ckpts, "ft", "last.pt"), state)
    assert meta["epoch"] == 0 and state.step > 0


def test_bare_state_dict_names_import_torch(tmp_path):
    """A bare ``state_dict`` where a full-state checkpoint belongs raises a
    ``ValueError`` that names ``import-torch`` (not ``KeyError: 'model'``)."""
    cfg, pth = _reference_pth(tmp_path, "detector")
    with pytest.raises(ValueError, match="import-torch"):
        restore_checkpoint(pth, init_detector_state(cfg, seed=0))
