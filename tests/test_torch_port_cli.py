"""The port's command line (``python -m tsr_tpu_torch``) against the JAX
package's (``python -m tsr_tpu``) on the CPU: the same commands, the same
options in every script (plus ``--device``), the same ``--synthetic``
tree, the partial-tree rebuild, ``--mesh`` (run on ranks the command
starts, refused by the commands without a multi-device path), and the
port's refusal of a missing card.

The parsers are read in process: ``ArgumentParser.parse_args`` is patched
to raise with the parser, so neither script's ``main`` runs further.
"""

import argparse
import json
import runpy
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import tsr_tpu.__main__ as jmain
from tsr_tpu.data import synthetic as jsynthetic
from tsr_tpu_torch import __main__ as tmain

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
REF_SCRIPTS = REPO / "scripts"
PORT_SCRIPTS = REPO / "tsr_tpu_torch" / "scripts"
COMMANDS = sorted(jmain.COMMANDS)


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parsed")
        self.parser = parser


def _parser_of(main, argv, monkeypatch):
    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as got:
        main(*argv)
    monkeypatch.undo()
    return got.value.parser


def _options(parser):
    """{dest: (option strings, default, type, choices, store_true, nargs)}
    of every option but --help."""
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None,
                     isinstance(a, argparse._StoreTrueAction), a.nargs)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def _port_main(command):
    return runpy.run_path(str(PORT_SCRIPTS / tmain.COMMANDS[command]),
                          run_name="port_script")["main"]


def test_commands_equal_reference():
    assert tmain.COMMANDS == jmain.COMMANDS
    assert len(tmain.COMMANDS) == 19
    for script in tmain.COMMANDS.values():
        assert (PORT_SCRIPTS / script).exists(), script
        assert (REF_SCRIPTS / script).exists(), script


def test_help_lists_every_command():
    out = subprocess.run([sys.executable, "-m", "tsr_tpu_torch", "--help"],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for name, script in tmain.COMMANDS.items():
        assert f"{name:<24} -> tsr_tpu_torch/scripts/{script}" in out.stdout
    bare = subprocess.run([sys.executable, "-m", "tsr_tpu_torch"],
                          capture_output=True, text=True, cwd=str(REPO),
                          timeout=120)
    unknown = subprocess.run(
        [sys.executable, "-m", "tsr_tpu_torch", "no-such-command"],
        capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert (bare.returncode, unknown.returncode) == (1, 1)
    assert "unknown command 'no-such-command'" in unknown.stdout


@pytest.mark.parametrize("command", COMMANDS)
def test_script_options_equal_reference(command, monkeypatch):
    """dest, option strings, default, type, choices, store_true and nargs
    of every option equal the reference script's; --device (default
    cuda) is the only extra."""
    sys.path.insert(0, str(REF_SCRIPTS))  # the reference's bare _common
    try:
        ref_main = runpy.run_path(str(REF_SCRIPTS / jmain.COMMANDS[command]),
                                  run_name="ref_script")["main"]
        ref = _options(_parser_of(ref_main, (), monkeypatch))
    finally:
        sys.path.remove(str(REF_SCRIPTS))
    got = _options(_parser_of(_port_main(command), ([],), monkeypatch))
    device = got.pop("device")
    assert device == (("--device",), "cuda", None, None, False, None)
    assert got == ref


@pytest.mark.parametrize("command", COMMANDS)
def test_script_help_exits_zero(command, capsys):
    with pytest.raises(SystemExit) as e:
        _port_main(command)(["--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out.lower()


@pytest.mark.parametrize("command", COMMANDS)
def test_default_device_raises_without_cuda(command, tmp_path):
    """Without --device cpu a command asks for CUDA and, on a machine
    without it, raises resolve_device's error before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        _port_main(command)(["--clean-dir", str(tmp_path / "none")])
    assert not (tmp_path / "none").exists()


def test_mesh_refused(tmp_path, capfd, monkeypatch):
    """``eval-baseline --mesh data=2 --device cpu`` now runs: the command
    starts two gloo ranks (the first prints, the Mesh line names the
    backend and devices) and exits 0 with the report of the command
    without --mesh. A command with no multi-device path (gen-noise) still
    refuses --mesh."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tree = tmp_path / "tree"
    jsynthetic.write_image_tree(str(tree), num_classes=2, per_class=5,
                                size=16)
    torch.manual_seed(0)
    from tsr_tpu_torch.models import VGG16
    torch.save(VGG16(num_classes=2, cfg=(8, "M", 16, "M"), fc_width=32,
                     input_size=16).state_dict(), tmp_path / "judge.pth")
    zoo_cfg = {"kind": "vgg16", "num_classes": 2, "cfg": [8, "M", 16, "M"],
               "fc_width": 32}
    (tmp_path / "judge").mkdir()
    (tmp_path / "judge" / "config.json").write_text(json.dumps(zoo_cfg))
    (tmp_path / "judge" / "model").write_bytes(
        (tmp_path / "judge.pth").read_bytes())
    argv = ["--clean-dir", str(tree), "--image-size", "16", "--device",
            "cpu", "--model", str(tmp_path / "judge"), "--batch-size", "4"]
    _port_main("eval-baseline")(argv)
    one = capfd.readouterr().out
    with pytest.raises(SystemExit) as e:
        _port_main("eval-baseline")(argv + ["--mesh", "data=2"])
    assert e.value.code == 0
    two = capfd.readouterr().out
    assert ("Mesh: {'data': 2, 'model': 1} over 2 ranks, backend gloo, "
            "devices ['cpu', 'cpu']") in two
    report = one[one.index("=" * 30):]
    assert report in two and two.count("Final Test Report") == 1
    with pytest.raises(SystemExit) as e:
        _port_main("gen-noise")(["--mesh", "data=2", "--device", "cpu",
                                 "--clean-dir", str(tmp_path)])
    assert "no multi-device path" in str(e.value.code)


def _read_tree(root):
    files = sorted(p for p in Path(root).glob("*/*"))
    return [(p.relative_to(root), cv2.imread(str(p))[:, :, ::-1])
            for p in files]


def test_synthetic_tree_equals_reference(tmp_path, capsys):
    """download --synthetic writes the reference's write_image_tree tree
    pixel for pixel, and the same marker."""
    port = tmp_path / "port"
    _port_main("download")(["--clean-dir", str(port), "--synthetic",
                            "--synthetic-classes", "3",
                            "--synthetic-per-class", "4", "--seed", "5",
                            "--device", "cpu"])
    assert f"Data ready at: {port}" in capsys.readouterr().out
    ref = tmp_path / "ref"
    jsynthetic.write_image_tree(
        str(ref), num_classes=3, per_class=4, size=jsynthetic.TREE_SIZE,
        seed=5, size_jitter=jsynthetic.TREE_JITTER)
    got, want = _read_tree(port), _read_tree(ref)
    assert [r for r, _ in got] == [r for r, _ in want] and len(got) == 12
    for (rel, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b), rel
    assert (json.loads((port / ".synthetic").read_text())
            == json.loads((ref / ".synthetic").read_text()))


def test_synthetic_tree_rebuilt_if_partial(tmp_path, capsys):
    """The port's twin of tests/test_scripts.py's: an interrupted
    --synthetic build (marker present, count short) is rebuilt on the next
    run; an unmarked tree is never touched."""
    clean = tmp_path / "Training"
    args = ["--clean-dir", str(clean), "--synthetic", "--synthetic-classes",
            "2", "--synthetic-per-class", "3", "--device", "cpu"]
    download = _port_main("download")

    def run01():
        download(args)
        return capsys.readouterr().out

    run01()
    imgs = sorted(clean.glob("*/*.ppm"))
    assert len(imgs) == 6 and (clean / ".synthetic").exists()
    for p in imgs[:3]:
        p.unlink()  # an interrupted write
    out = run01()
    assert "incomplete" in out and "rebuilding" in out.lower(), out
    assert len(list(clean.glob("*/*.ppm"))) == 6

    # no marker (real data): left alone even with odd counts
    (clean / ".synthetic").unlink()
    imgs = sorted(clean.glob("*/*.ppm"))
    imgs[0].unlink()
    run01()
    assert len(list(clean.glob("*/*.ppm"))) == 5


def test_missing_tree_without_synthetic(tmp_path):
    with pytest.raises(SystemExit, match="not found"):
        _port_main("gen-noise")(["--clean-dir", str(tmp_path / "none"),
                                 "--device", "cpu"])


def test_orbax_checkpoint_refused(tmp_path):
    """An orbax directory of the JAX package (its model is a directory) is
    refused with a message naming the way out."""
    from tsr_tpu_torch import zoo

    (tmp_path / "ckpt" / "model").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        zoo.load_model("simple_unet", str(tmp_path / "ckpt"), device="cpu")
