"""The port's multi-process paths on the CPU, over gloo: two processes
joined over ``env://`` as torchrun would start them (the counterpart of
``tests/test_distributed.py``), and the commands' ``--mesh``
(``python -m tsr_tpu_torch ... --mesh``), which start their own ranks or
join torchrun's.
"""

import operator
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsr_tpu import configs as jconfigs
from tsr_tpu.models import SimpleUNet as JSimpleUNet
from tsr_tpu.train import common as jcommon
from tsr_tpu_torch import checkpoint
from tsr_tpu_torch.parallel import launch

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    # prepend (not replace) PYTHONPATH: the environment may rely on what
    # is already on it
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        if k not in extra:
            env.pop(k, None)
    return env


def _single_process_loss():
    """tsr_tpu's step on the same data, unsharded, and its initial weights
    as the port's state dict."""
    rng = np.random.default_rng(0)
    bad = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    clean = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    model = JSimpleUNet(widths=(4, 8))
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    # converted first: the jitted step donates (deletes) the state's arrays
    sd = checkpoint.simple_unet_from_jax(jax.device_get(v))
    state = jcommon.TrainState.create(
        model.apply, v,
        jcommon.restoration_optimizer(jconfigs.RestorationTrainConfig()))
    step = jcommon.make_restoration_train_step(pixel="mse")
    _, aux = step(state, jnp.asarray(bad), jnp.asarray(clean))
    return float(aux["loss"]), sd


def test_two_process_loss_parity(tmp_path):
    """Two processes over env:// (MASTER_ADDR/PORT, WORLD_SIZE, RANK):
    each decodes its half of the batch (process_shard), the halves form
    one batch sharded over the data axis (make_global_batch), and one
    MSE step of a SimpleUNet(widths=(4, 8)) runs on it. Both ranks print
    the same loss, within 1e-5 relative of tsr_tpu's one-process loss."""
    ref, sd = _single_process_loss()
    weights = tmp_path / "unet.pth"
    torch.save(sd, weights)
    port = str(_free_port())
    code = ("from tsr_tpu_torch.parallel import checks\n"
            f"print('DIST_LOSS', repr(checks.restoration_two_process("
            f"{str(weights)!r})))\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(REPO),
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE="2",
                 RANK=str(i)))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    losses = []
    for rc, out, err in outs:
        assert rc == 0, f"rank failed:\n{out}\n{err[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("DIST_LOSS")]
        assert line, out
        losses.append(float(line[0].split()[1]))
    assert losses[0] == losses[1], losses
    assert np.isclose(losses[0], ref, rtol=1e-5), (losses[0], ref)


def _cli(args, cwd, timeout=300, **env):
    return subprocess.run([sys.executable, "-m", "tsr_tpu_torch", *args],
                          cwd=cwd, env=_env(**env), capture_output=True,
                          text=True, timeout=timeout)


COMMON = ["--synthetic", "--synthetic-classes", "2",
          "--synthetic-per-class", "12", "--image-size", "32",
          "--device", "cpu"]


def _losses(text):
    return [float(x) for x in re.findall(r"loss (\d+\.\d+)", text)]


def test_train_unified_mesh_matches_the_command(tmp_path):
    """train-unified --mesh data=2 --device cpu on a synthetic tree (the
    command starts two gloo ranks itself, the Mesh line says so): its
    epoch's train and validation losses within the reference's 2e-3 of
    the command without --mesh (the host-streamed loop the mesh takes),
    and the checkpoint written once."""
    assert _cli(["download", *COMMON], tmp_path).returncode == 0
    one = _cli(["train-unified", *COMMON, "--judge", "none", "--epochs",
                "1", "--batch-size", "4", "--host-stream", "--save", "one"],
               tmp_path)
    assert one.returncode == 0, one.stderr[-2000:]
    two = _cli(["train-unified", *COMMON, "--judge", "none", "--epochs",
                "1", "--batch-size", "4", "--mesh", "data=2", "--save",
                "two"], tmp_path)
    assert two.returncode == 0, two.stderr[-3000:]
    assert ("Mesh: {'data': 2, 'model': 1} over 2 ranks, backend gloo, "
            "devices ['cpu', 'cpu']") in two.stdout
    a, b = _losses(one.stdout), _losses(two.stdout)
    assert len(a) == len(b) == 2, (one.stdout, two.stdout)
    np.testing.assert_allclose(b, a, rtol=2e-3)
    assert two.stdout.count("Done. Checkpoint at two") == 1
    assert (tmp_path / "two" / "model").exists()


def test_mesh_size_must_match_the_world(tmp_path):
    """Under torchrun's variables a --mesh whose size is not WORLD_SIZE
    exits non-zero before joining any group, with an error that names
    both; so does data=-1 with a world that the model axis does not
    divide."""
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="3", RANK="0")
    r = _cli(["eval-baseline", *COMMON, "--mesh", "data=2"], tmp_path,
             timeout=120, **env)
    assert r.returncode != 0
    assert "data=2" in r.stderr and "WORLD_SIZE=3" in r.stderr, r.stderr
    r = _cli(["eval-baseline", *COMMON, "--mesh", "data=-1,model=2"],
             tmp_path, timeout=120, **env)
    assert r.returncode != 0 and "model=2" in r.stderr, r.stderr


def test_a_failing_rank_fails_the_launch():
    """A rank that raises ends its launch with that rank's error (no rank
    is left waiting), and the launcher leaves no process running."""
    import multiprocessing

    with pytest.raises(Exception, match="ZeroDivisionError"):
        launch.spawn(operator.truediv, 2, (1, 0), device="cpu", threads=1,
                     timeout=120)
    assert not multiprocessing.active_children()
