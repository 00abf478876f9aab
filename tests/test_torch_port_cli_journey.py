"""The user journeys of tests/test_journey.py through the port's scripts,
in process on the CPU, then the same weights through both command lines.

The three journeys (numbered scripts, the unified leg, visualisation and
interpretability) run at 32 px on a 2-class x 4-image synthetic tree with
``--device cpu`` and the reference journeys' assertions on artifacts and
printed lines. The parity test writes seeded reference-format ``.pth``
files (the judge, a SimpleUNet, the ResUNet), runs ``eval-baseline``,
``restore``, ``eval-restoration --fused`` and ``eval-unified --fused``
through the JAX package's scripts (subprocesses, ``JAX_PLATFORMS=cpu``,
as tests/test_journey.py runs them) and through the port's on the same
trees with ``--resize host``, and holds the accuracy reports equal and
``restore``'s PSNR/SSIM within 0.05 dB and 1e-3. Its weights come from
``tsr_tpu_torch.parity`` (a nearest-centroid judge, restorers that pass
their input through with an offset), so that each command's report has
a row off the single-class 50 %: plain random weights read 50 % on every
tree, whatever a script did to the images.
"""

import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tsr_tpu import checkpoint as jckpt
from tsr_tpu_torch import __main__ as tmain
from tsr_tpu_torch import parity
from tsr_tpu_torch.models import ResUNet, SimpleUNet, VGG16

torch.set_num_threads(4)
REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, JAX_PLATFORMS="cpu",
           PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
ACC_RE = re.compile(r"Result \[(.+?)\] Accuracy: ([0-9.]+)%")


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A fresh working directory: the scripts' default trees are relative
    to it (./data/processed, ./data/restored)."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _common(tmp):
    return ["--clean-dir", str(tmp / "data" / "gtsrb" / "Training"),
            "--ckpt-dir", str(tmp / "ckpt"), "--image-size", "32",
            "--synthetic", "--synthetic-classes", "2",
            "--synthetic-per-class", "4"]


def run(command, *extra, tmp):
    """The port's ``command`` in process on the CPU; its printed output."""
    script = REPO / "tsr_tpu_torch" / "scripts" / tmain.COMMANDS[command]
    main = runpy.run_path(str(script), run_name="journey")["main"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([*_common(tmp), *extra, "--device", "cpu"])
    return buf.getvalue()


def test_numbered_script_journey(workdir):
    tmp = workdir
    out = run("download", tmp=tmp)
    assert "Data ready" in out
    clean = tmp / "data" / "gtsrb" / "Training"
    assert len(list(clean.glob("*/*"))) == 8

    run("gen-noise", tmp=tmp)
    noise = tmp / "data" / "processed" / "Noise"
    assert len(list(noise.glob("*/*"))) == 8

    run("train-judge", "--epochs", "2", "--batch-size", "4", "--optimizer",
        "adamw", tmp=tmp)
    assert (tmp / "ckpt" / "vgg16_baseline").exists()

    run("train-restorer", "--task", "noise", "--epochs", "1",
        "--batch-size", "4", "--identity-frac", "0.25", tmp=tmp)
    assert (tmp / "ckpt" / "restoration_noise").exists()

    out = run("restore", "--tasks", "noise", "--batch-size", "4", tmp=tmp)
    restored = tmp / "data" / "restored" / "Noise"
    assert len(list(restored.glob("*/*"))) == 8, out
    assert re.search(r"PSNR", out), out

    out = run("eval-restoration", "--batch-size", "4", tmp=tmp)
    accs = ACC_RE.findall(out)
    names = [n for n, _ in accs]
    assert any("Clean" in n for n in names), out
    assert any("Noise (Distorted)" in n for n in names), out
    assert any("Noise" in n and "Restored" in n for n in names), out
    for _, v in accs:
        assert 0.0 <= float(v) <= 100.0


def test_unified_script_journey(workdir):
    """Unified leg (ref README chain 16->14->17->18->15): compound tree ->
    unified ResUNet train -> unified restore -> fused benchmark -> demo."""
    tmp = workdir
    run("download", tmp=tmp)
    run("gen-compound", tmp=tmp)
    compound = tmp / "data" / "processed" / "Compound"
    assert len(list(compound.glob("*/*"))) == 8

    run("train-judge", "--epochs", "1", "--batch-size", "4", "--optimizer",
        "adamw", tmp=tmp)
    run("train-unified", "--epochs", "1", "--batch-size", "4", tmp=tmp)
    assert list((tmp / "ckpt").glob("*uni*"))

    out = run("restore-unified", "--batch-size", "4", "--metrics", tmp=tmp)
    restored = tmp / "data" / "restored" / "Compound"
    assert len(list(restored.glob("*/*"))) == 8, out

    out = run("eval-unified", "--batch-size", "4", "--fused", tmp=tmp)
    assert re.findall(r"Accuracy: ([0-9.]+)%", out), out

    out = run("demo-unified", "--out", str(tmp / "demo.png"), tmp=tmp)
    assert (tmp / "demo.png").exists(), out


def test_viz_interpret_script_journey(workdir):
    """Viz/interpretability leg (ref:10-13): comparison grid, hidden-state
    heatmaps, UMAP .pt export, cascade stress figures — on a tiny tree with
    1-epoch models (artifact existence + schema, not quality)."""
    tmp = workdir
    run("download", tmp=tmp)
    for command in ("gen-noise", "gen-blur", "gen-fog"):
        run(command, tmp=tmp)
    run("train-judge", "--epochs", "1", "--batch-size", "4", "--optimizer",
        "adamw", tmp=tmp)
    for task in ("noise", "blur", "fog"):
        run("train-restorer", "--task", task, "--epochs", "1",
            "--batch-size", "4", tmp=tmp)
    run("restore", "--batch-size", "4", tmp=tmp)

    run("visualize", "--out", str(tmp / "grid.png"), tmp=tmp)
    assert (tmp / "grid.png").exists()

    run("hidden-states", "--out", str(tmp / "hidden.png"), tmp=tmp)
    assert (tmp / "hidden.png").exists()

    run("embeddings", "--samples-per-mode", "8", "--out-pt",
        str(tmp / "emb.pt"), "--out-img", str(tmp / "emb.png"), tmp=tmp)
    d = torch.load(str(tmp / "emb.pt"), weights_only=False)
    # schema of the reference's shipped artifact (ref:12:145-150)
    assert set(d) >= {"embeddings", "labels", "original_features"}
    assert d["embeddings"].shape[1] == 2
    assert d["original_features"].shape[1] == 512

    out = run("stress-test", "--num-samples", "2", "--out-dir",
              str(tmp / "pr"), tmp=tmp)
    figs = list((tmp / "pr").glob("pipeline_sample_*.png"))
    assert len(figs) == 2, out
    assert "confidence" in out.lower(), out


# ------------------------------------------------- both command lines

def _start_reference(script, *args, cwd):
    """The reference's ``script`` started as a subprocess."""
    return subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=str(cwd))


def _output(proc, script):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"{script}\n{out[-1500:]}\n{err[-2500:]}"
    return out


def _accuracies(out):
    return {name: float(v) for name, v in ACC_RE.findall(out)}


def _restore_metrics(out):
    return (float(re.search(r"Average PSNR: ([0-9.]+) dB", out).group(1)),
            float(re.search(r"Average SSIM: (-?[0-9.]+)", out).group(1)))


def test_same_weights_through_both_command_lines(workdir):
    tmp = workdir
    run("download", tmp=tmp)
    for command in ("gen-noise", "gen-compound"):
        run(command, tmp=tmp)

    # seeded reference-format weights whose reports can differ (plain
    # random ones give every image one class: 50 % on every tree); the
    # restorer also as an orbax checkpoint for the reference and a port
    # checkpoint for the port
    torch.manual_seed(11)
    unet = parity.pass_through(SimpleUNet())
    resunet = parity.pass_through(ResUNet())
    noise, compound = (tmp / "data" / "processed" / t
                       for t in ("Noise", "Compound"))
    judge = parity.spread_judge(
        VGG16(num_classes=2, input_size=32),
        [(tmp / "data" / "gtsrb" / "Training", None), (noise, None),
         (noise, unet), (compound, None), (compound, resunet)], 32)
    torch.save(judge.state_dict(), tmp / "judge.pth")
    torch.save(resunet.state_dict(), tmp / "unified.pth")
    unet_sd = unet.state_dict()
    torch.save(unet_sd, tmp / "unet.pth")
    (tmp / "port_ckpt" / "restoration_noise").mkdir(parents=True)
    torch.save(unet_sd, tmp / "port_ckpt" / "restoration_noise" / "model")
    jckpt.save_train_state(
        str(tmp / "ref_ckpt" / "restoration_noise" / "model"),
        jckpt.simple_unet_from_pth(jckpt.load_pth(str(tmp / "unet.pth"))))

    shared = ["--clean-dir", str(tmp / "data" / "gtsrb" / "Training"),
              "--image-size", "32", "--batch-size", "4"]
    cases = {
        "eval-baseline": ("06_test_baseline.py", ["--model", "judge.pth",
                                                  "--resize", "host"]),
        "eval-restoration": ("09_test_baseline.py", [
            "--model", "judge.pth", "--fused", "--resize", "host"]),
        "eval-unified": ("18_test_unified_benchmark.py", [
            "--model", "judge.pth", "--unified", "unified.pth", "--fused",
            "--resize", "host"]),
        "restore": ("08_run_inference.py", ["--tasks", "noise", "--resize",
                                            "host"]),
    }
    # the reference's four runs at once (none reads what another writes);
    # the port's in process meanwhile, its restore after the reference's
    procs = {command: _start_reference(script, *shared, "--ckpt-dir",
                                       str(tmp / "ref_ckpt"), *extra,
                                       cwd=tmp)
             for command, (script, extra) in cases.items()}
    try:
        for command, (script, extra) in cases.items():
            if command == "restore":
                ref = _output(procs[command], script)
            port_main = runpy.run_path(
                str(REPO / "tsr_tpu_torch" / "scripts"
                    / tmain.COMMANDS[command]), run_name="parity")["main"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                port_main([*shared, "--ckpt-dir", str(tmp / "port_ckpt"),
                           *extra, "--device", "cpu"])
            got = buf.getvalue()
            if command == "restore":
                (p_psnr, p_ssim), (r_psnr, r_ssim) = (
                    _restore_metrics(got), _restore_metrics(ref))
                assert abs(p_psnr - r_psnr) <= 0.05, (p_psnr, r_psnr)
                assert abs(p_ssim - r_ssim) <= 1e-3, (p_ssim, r_ssim)
                continue
            ref = _output(procs[command], script)
            accs = _accuracies(got)
            assert accs and accs == _accuracies(ref), (command, got, ref)
            # 50 % is what a judge reads that gives every image one class
            assert any(v != 50.0 for v in accs.values()), (command, accs)
            if command != "eval-baseline":
                fused = [v for name, v in accs.items() if "fused" in name]
                assert fused and 50.0 not in fused, (command, accs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# ------------------------------------------------------- parity weights

@pytest.mark.parametrize("model", [SimpleUNet(widths=(8, 16)),
                                   ResUNet(widths=(8, 16),
                                           bottleneck_width=16)],
                         ids=["simple_unet", "resunet"])
def test_pass_through_restorer_returns_input_plus_offset(model):
    """parity.pass_through: the output is the input plus the offset; the
    ResUNet's copy passes one batch norm at its initial statistics
    (a factor of 1 / sqrt(1 + 1e-5))."""
    x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = parity.pass_through(model).eval()(x)
    assert (out - (x + parity.OFFSET)).abs().max() <= 1e-5


@pytest.mark.parametrize("seed", range(4))
def test_spread_judge_reads_off_one_class_in_every_run(workdir, seed):
    """parity.spread_judge fitted on four runs (clean, noise, compound,
    compound through a pass-through ResUNet): no run reads 50 %, where
    the plain init gives every image one class. Each distortion and the
    restorer's offset shift all of a run's features alike; without
    taking the class directions orthogonal to those shifts, three of
    these four seeds leave some run at 50 %."""
    from tsr_tpu_torch import eval as teval
    for command in ("download", "gen-noise", "gen-compound"):
        run(command, tmp=workdir)
    clean = str(workdir / "data" / "gtsrb" / "Training")
    noise, compound = (str(workdir / "data" / "processed" / t)
                       for t in ("Noise", "Compound"))
    torch.manual_seed(seed)
    judge = VGG16(num_classes=2, cfg=(8, 8, "M", 16, "M", 16, "M"),
                  fc_width=32, input_size=32)
    resunet = parity.pass_through(ResUNet(widths=(8, 16),
                                          bottleneck_width=16))
    runs = [(clean, None), (noise, None), (compound, None),
            (compound, resunet)]
    plain = teval.evaluate_directory(judge, clean, size=32, device="cpu")
    parity.spread_judge(judge, runs, 32)
    fitted = [teval.evaluate_directory(judge, tree, size=32,
                                       restorer=restorer,
                                       device="cpu")["top1"]
              for tree, restorer in runs]
    assert plain["top1"] == 0.5 and 0.5 not in fitted, (plain, fitted)
