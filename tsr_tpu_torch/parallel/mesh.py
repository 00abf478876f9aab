"""Device mesh and sharding layer.

Port of ``tsr_tpu/parallel/mesh.py``: one process per device, each a rank
of a ``torch.distributed`` group, laid out as a 2-D ``(data, model)``
mesh (``torch.distributed.device_mesh``) with a process group per axis.

- **data axis**: each rank takes its rows of every global batch; batch
  norm statistics cover the global batch (``models.layers.BatchNorm2d``
  with ``sync_group``) and gradients are averaged over the axis before
  each update (``train.common.TrainState``), so a step equals the
  one-device step on the whole batch.
- **model axis**: Megatron tensor parallelism on the parameters that the
  rules name. Where XLA inserts the collectives that a sharding implies,
  the port swaps each matched module for its parallel form, with the
  collectives in its forward and backward (``parallel.collectives``):

  ``"column"``         the weight's output rows (and the bias) split;
                       the output stays split (the reference's
                       ``P(None, "model")`` kernel, ``P("model")`` bias);
  ``"row"``            the weight's input columns split, the partial
                       products summed over the axis, the bias kept whole
                       (``P("model", None)``);
  ``"column_gather"``  a convolution's output channels (and bias) split,
                       the output gathered whole again
                       (``P(None, None, None, "model")``).

  Optimizer moments of a split parameter are split alike. Everything that
  no rule names is replicated.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tsr_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear
from tsr_tpu_torch.parallel import collectives as coll

AXIS_NAMES = ("data", "model")


class Mesh:
    """This rank's place in a ``(data, model)`` layout of ranks.

    ``shape`` maps each axis name to its size; ``data_group`` and
    ``model_group`` are the process groups of this rank's row and column
    of the layout, ``data_rank`` / ``model_rank`` its index in each.
    ``device`` is the rank's device and ``backend`` the groups' backend.
    """

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = backend
        self.axis_names = AXIS_NAMES
        self.shape = dict(zip(AXIS_NAMES, device_mesh.mesh.shape))
        self.data, self.model = self.shape["data"], self.shape["model"]
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        self.data_rank = device_mesh.get_local_rank("data")
        self.model_rank = device_mesh.get_local_rank("model")
        self.ranks = device_mesh.mesh.flatten().tolist()
        self.is_main = dist.get_rank() == self.ranks[0]

    def rows(self, n_local: int) -> Tuple[int, int]:
        """``(row0, total)``: where this rank's ``n_local`` rows start in
        the global batch, and its size."""
        return self.data_rank * n_local, n_local * self.data

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a one-element all-reduce on the
        rank's device, which every backend takes)."""
        t = torch.zeros(1, device=self.device)
        for g in (self.data_group, self.model_group):
            dist.all_reduce(t, group=g)

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        return coll.all_reduce_sum(x, self.data_group)

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        return coll.all_reduce_sum(x, self.data_group) / self.data

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks {self.ranks}, backend "
                f"{self.backend}, device {self.device})")


def make_mesh(data: int = -1, model: int = 1, device=None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A ``(data, model)`` mesh over ``ranks`` (default: the whole world
    of the initialized process group). ``data=-1`` takes all remaining
    ranks. ``device`` defaults to the rank's device as
    ``parallel.distributed.initialize`` recorded it (an error when it
    recorded none: the CPU is never taken by default).

    Every rank of the world must call this (each group is created by all
    ranks); a rank outside ``ranks`` gets None.
    """
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from tsr_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: run under "
            "torchrun, through --mesh, or call "
            "parallel.distributed.initialize(...) first")
    world = dist.get_world_size()
    n = world if ranks is None else len(ranks)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks do not divide by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh data={data} x model={model} needs "
                         f"{data * model} ranks, the world has {n}")
    device = torch.device(device) if device is not None \
        else distributed.rank_device()
    if ranks is None:
        dm = init_device_mesh(device.type, (data, model),
                              mesh_dim_names=AXIS_NAMES)
    else:
        dm = DeviceMesh(device.type,
                        torch.tensor(list(ranks)).reshape(data, model),
                        mesh_dim_names=AXIS_NAMES)
        if dist.get_rank() not in ranks:
            return None
    return Mesh(dm, device, dist.get_backend())


def parse_mesh_spec(spec: Optional[str]) -> Optional[dict]:
    """Parse a ``--mesh`` CLI spec: ``"data=8"``, ``"data=4,model=2"``, or
    a bare int (``"8"`` == ``"data=8"``). Returns None for None/empty."""
    if not spec:
        return None
    out = {"data": 1, "model": 1}
    if spec.isdigit():
        out["data"] = int(spec)
        return out
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in out or not v.strip().lstrip("-").isdigit():
            raise ValueError(
                f"bad mesh spec {spec!r}; want e.g. 'data=8' or "
                "'data=4,model=2'")
        out[k] = int(v)
    return out


def mesh_from_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
    axes = parse_mesh_spec(spec)
    if axes is None:
        return None
    return make_mesh(data=axes["data"], model=axes["model"], device=device)


# Module-name regex -> parallel style (see the module docstring). The
# Megatron split of the giant VGG classifier: classifier.0 column-parallel,
# classifier.3 row-parallel (the reference's classifier_0 / classifier_3).
VGG_TP_RULES = (
    (r"classifier\.0", "column"),
    (r"classifier\.3", "row"),
)

# ResUNet: the bottleneck blocks' two 3x3 convolutions (the reference's
# bottleneck1-3 conv1/conv2; its shortcut_conv matches no rule there
# either), output channels split so their optimizer state splits too.
RESTORER_TP_RULES = (
    (r"bottleneck\.\d+\.conv_block\.[03]", "column_gather"),
)

_WEIGHT_DIM = {"column": 0, "row": 1, "column_gather": 0}


class ColumnParallelLinear(Linear):
    """``Linear`` holding this rank's output rows; the output stays split."""

    def forward(self, x):
        return super().forward(coll.copy_to_group(x, self.tp_group))


class RowParallelLinear(Linear):
    """``Linear`` holding this rank's input columns; partial products are
    summed over the model axis before the whole bias is added."""

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        y = coll.reduce_from_group(y, self.tp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ColumnGatherConv2d(Conv2d):
    """``Conv2d`` holding this rank's output channels; the output is
    gathered whole over the model axis."""

    def forward(self, x):
        y = super().forward(coll.copy_to_group(x, self.tp_group))
        return coll.gather_from_group(y, 1, self.tp_group)


_PARALLEL = {("column", Linear): ColumnParallelLinear,
             ("row", Linear): RowParallelLinear,
             ("column_gather", Conv2d): ColumnGatherConv2d}


class MeshDropout(nn.Dropout):
    """Dropout whose mask is drawn for the global batch at the full width
    (one ``F.dropout`` of ones, as one device would draw it for the whole
    batch) and sliced to this rank's rows, and to its model columns where
    the input is column-split (``split``). Every rank draws alike from
    generators seeded alike, so ranks that hold the same rows hold the
    same mask."""

    def __init__(self, p: float, mesh: Mesh, split: bool):
        super().__init__(p)
        self.mesh, self.split = mesh, split

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        m = self.mesh
        n, w = x.shape[0], x.shape[1]
        full = (n * m.data, w * m.model if self.split else w)
        mask = F.dropout(torch.ones(full, dtype=x.dtype, device=x.device),
                         self.p, True)
        col0 = m.model_rank * w if self.split else 0
        return x * mask[m.data_rank * n:(m.data_rank + 1) * n,
                        col0:col0 + w]


def _style(name: str, rules: Sequence) -> Optional[str]:
    for pat, style in rules:
        if re.fullmatch(pat, name):
            return style
    return None


def _replicate(module: nn.Module, mesh: Mesh) -> None:
    """Broadcast every parameter and buffer from the mesh's first rank
    (first over the data axis, then over the model axis)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            for g in (mesh.data_group, mesh.model_group):
                src = dist.get_global_rank(g, 0)
                buf = t.data.contiguous()
                dist.broadcast(buf, src, group=g)
                if buf.data_ptr() != t.data.data_ptr():
                    t.data.copy_(buf)


def _local_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    if t.shape[dim] % mesh.model:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"divide by model={mesh.model}")
    k = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_rank * k, k).contiguous()


def shard_variables(module: nn.Module, mesh: Mesh,
                    rules: Sequence = ()) -> nn.Module:
    """Place ``module`` on ``mesh`` in place and return it: parameters and
    buffers replicated from the mesh's first rank, batch norms synced over
    the data axis (when it has more than one rank), dropout drawn for the
    global batch (:class:`MeshDropout`), and each module matched by
    ``rules`` holding only this rank's slice of its parameters, in its
    parallel form. A split parameter carries ``tp_dim`` (the split
    dimension)."""
    _replicate(module, mesh)
    for name, m in list(module.named_modules()):
        if isinstance(m, BatchNorm2d):
            m.sync_group = mesh.data_group if mesh.data > 1 else None
        style = _style(name, rules) if mesh.model > 1 else None
        if style is None:
            continue
        cls = next((c for (s, base), c in _PARALLEL.items()
                    if s == style and type(m) is base), None)
        if cls is None:
            raise ValueError(f"rule {style!r} does not apply to {name} "
                             f"({type(m).__name__})")
        dim = _WEIGHT_DIM[style]
        m.weight.data = _local_slice(m.weight.data, dim, mesh)
        m.weight.tp_dim = dim
        if m.bias is not None and style != "row":
            m.bias.data = _local_slice(m.bias.data, 0, mesh)
            m.bias.tp_dim = 0
        m.__class__ = cls
        m.tp_group = mesh.model_group
    split = False
    for seq in [s for s in module.modules() if isinstance(s, nn.Sequential)]:
        for i, child in enumerate(list(seq)):
            if isinstance(child, ColumnParallelLinear):
                split = True
            elif isinstance(child, RowParallelLinear):
                split = False
            elif type(child) is nn.Dropout:
                seq[i] = MeshDropout(child.p, mesh, split).train(
                    child.training)
    return module


def shard_state(state, mesh: Mesh, tp_rules: Sequence = ()):
    """Place a ``train.common.TrainState`` on ``mesh``: its model as
    :func:`shard_variables` places it, the optimizer moments of every split
    parameter split alike, and ``state.mesh`` set, so the steps average
    gradients and metrics over the data axis and the clip sums its norm
    over the model axis. With ``tp_rules=()`` this is pure data
    parallelism."""
    shard_variables(state.model, mesh, tp_rules)
    for p, st in state.optimizer.state.items():
        dim = getattr(p, "tp_dim", None)
        if dim is None:
            continue
        for k, v in st.items():
            if torch.is_tensor(v) and v.ndim == p.ndim and v.shape != p.shape:
                st[k] = _local_slice(v, dim, mesh)
    state.optimizer.model_group = (mesh.model_group if mesh.model > 1
                                   else None)
    state.mesh = mesh
    return state


def gather_tensor(t: torch.Tensor, dim: Optional[int], mesh: Mesh
                  ) -> torch.Tensor:
    """The whole tensor of a split one (``dim``), else ``t`` itself."""
    if dim is None or mesh.model == 1:
        return t
    return coll.all_gather_cat(t, dim, mesh.model_group)


def gathered_state_dict(module: nn.Module, mesh: Mesh) -> Dict:
    """``module.state_dict()`` with every split parameter gathered whole:
    what one device would hold. A collective: every rank calls it."""
    dims = {n: getattr(p, "tp_dim", None)
            for n, p in module.named_parameters()}
    return {k: gather_tensor(v, dims.get(k), mesh)
            for k, v in module.state_dict().items()}


def gathered_state_tree(state, mesh: Mesh) -> Dict:
    """``zoo.state_tree(state)`` with the split parameters and their
    optimizer moments gathered whole (a collective): the checkpoint one
    device would write for the same parameters."""
    opt = state.optimizer.state_dict()
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        dim = getattr(p, "tp_dim", None)
        if dim is None or i not in opt["state"]:
            continue
        opt["state"][i] = {
            k: (gather_tensor(v, dim, mesh)
                if torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in opt["state"][i].items()}
    return {"model": gathered_state_dict(state.model, mesh),
            "optimizer": opt, "schedule": state.schedule.state_dict(),
            "step": state.step}


def _rows(x, mesh: Mesh):
    n = x.shape[0] // mesh.data
    return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (over the data axis) of one global batch or of a
    tuple of them (numpy arrays or tensors, sliced where they are)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_rows(x, mesh) for x in batch)
    return _rows(batch, mesh)


def shard_batch_or_replicate(batch, mesh: Mesh):
    """``(batch, split)``: this rank's rows when the leading dimension
    divides by the data axis (``split`` True); otherwise the whole batch
    (the uneven final validation / eval batch), computed alike on every
    rank and to be counted once (``split`` False): exact either way."""
    leaves = batch if isinstance(batch, (tuple, list)) else (batch,)
    lead = {x.shape[0] for x in leaves}
    if len(lead) == 1 and next(iter(lead)) % mesh.data == 0:
        return shard_batch(batch, mesh), True
    return batch, False
