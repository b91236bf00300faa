"""The walking core of the program passes, the port of
``tpu_bfs/analysis/hlo.py``. JAX reads two artifacts: the compiled HLO's
collective instructions and the traced program. The port has two
counterparts, one a half:

- **the wire tap** (:class:`WireTap`): every byte the port puts on a wire
  goes through the four collectives of ``parallel/mesh.Mesh``. While a
  tap is on, each call records one :class:`Collective` (the op under
  HLO's name, the bytes this rank sends, the pieces, the group, the
  operand's shape and dtype) before it runs. Off, a call costs one
  ``None`` check. ``utils/wirecheck.py`` prices every exchange branch
  from these records, and ``analysis/uniformity.py`` compares the ranks'
  ordered records after a run.
- **the FX walk** (:func:`walk_program`): a ``torch.export``
  ``ExportedProgram`` (``utils/aot.export_program``), nested graphs
  included. Per node: the dtypes of its outputs, whether it is a host
  op (a read of a device value, a copy to the CPU, a data-dependent
  shape, a Python callback), its new bytes; per program: the user
  inputs it writes in place and a buffer-liveness peak (JAX's
  ``hlo_buffer_estimate``). The registered kernel ops
  (``tpu_bfs_torch::ell_expand``, ``tpu_bfs_torch::tile_spmm``) are
  nodes like any other: their outputs and mutations come from their
  schemas.

Wire conventions (JAX's, ``tpu_bfs/utils/wirecheck.py:13-27``), per rank
over a group of P ranks, operand bytes b:

- ``collective-permute`` (``ring_shift``) sends its whole operand once: b;
- ``all-to-all`` keeps its own piece and sends P - 1: (P - 1) b / P;
- ``all-gather`` (``all_gather_rows``) sends its piece to P - 1 ranks:
  (P - 1) b, the gathered result's (P - 1) / P;
- ``all-reduce``: a control scalar or pair (at most two elements) is
  priced at its bytes, flat, as the byte models carry it; a larger one
  at the bandwidth-optimal 2 (P - 1) b / P;
- a one-rank group, or a one-rank subgroup, sends nothing.

Gloo ranks sharing a card stage a send through host memory: the tap
records the payload once, at the call.
"""

from __future__ import annotations

import dataclasses
import operator

import torch

#: Ops whose output a host read, a copy to the CPU or a data-dependent
#: size forces: each is a device-to-host sync where it runs.
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_consecutive", "aten.unique_dim",
    "aten.bincount", "aten.is_nonzero", "aten.equal", "aten.allclose",
    "aten.repeat_interleave.Tensor",
})
_COPY_OPS = frozenset({"aten._to_copy", "aten.to", "aten.copy_", "aten._copy_from",
                       "aten.copy"})
#: Modules whose callables in a graph are symbolic bookkeeping, not host code.
_SYMBOLIC_MODULES = ("_operator", "operator", "math", "torch", "builtins")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call as the tap saw it on this rank (JAX's
    ``analysis/hlo.Collective``, with the group and the operand)."""

    op: str  # all-gather | all-reduce | all-to-all | collective-permute
    wire_bytes: float  # bytes this rank sends (module docstring)
    pieces: int  # all-to-all: the P pieces; else 1
    group: tuple  # the group's global ranks, in group order
    shape: tuple
    dtype: str

    @property
    def operand_bytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * _itemsize(self.dtype)

    @property
    def signature(self) -> tuple:
        """What every rank of a group must agree on, in call order."""
        return (self.op, self.group, self.shape, self.dtype)


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def wire_bytes(op: str, p: int, nbytes: int, numel: int) -> float:
    """The bytes one rank sends for ``op`` over ``p`` ranks of an operand
    of ``nbytes`` bytes (module docstring)."""
    if p <= 1:
        return 0.0
    if op == "all-gather":
        return float((p - 1) * nbytes)
    if op == "all-to-all":
        return float((p - 1) * nbytes / p)
    if op == "collective-permute":
        return float(nbytes)
    if op == "all-reduce":
        return float(nbytes) if numel <= 2 else float(2 * (p - 1) * nbytes / p)
    raise ValueError(f"unknown collective {op!r}")


class WireTap:
    """Records every ``parallel/mesh.Mesh`` collective of this process
    while on (``with WireTap() as tap:``); :attr:`calls` in call order.
    Taps nest: a call records in every tap that is on."""

    def __init__(self):
        self.calls: list[Collective] = []
        self._prev = None

    def record(self, mesh, op: str, t: torch.Tensor) -> None:
        p = int(mesh.num_shards)
        pieces = p if op == "all-to-all" else 1
        group = tuple(mesh.members) if mesh.members is not None else tuple(range(p))
        nbytes = t.numel() * t.element_size()
        self._append(Collective(op, wire_bytes(op, p, nbytes, t.numel()), pieces, group,
                                tuple(int(d) for d in t.shape),
                                str(t.dtype).removeprefix("torch.")))

    def _append(self, c: Collective) -> None:
        self.calls.append(c)
        if self._prev is not None:
            self._prev._append(c)

    def __enter__(self) -> WireTap:
        from tpu_bfs_torch.parallel import mesh

        self._prev, mesh._TAP = mesh._TAP, self
        return self

    def __exit__(self, *exc) -> None:
        from tpu_bfs_torch.parallel import mesh

        mesh._TAP = self._prev

    def signature(self) -> list[tuple]:
        return [c.signature for c in self.calls]


def total_wire_bytes(calls) -> float:
    return float(sum(c.wire_bytes for c in calls))


# --- the FX walk ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NodeInfo:
    """One ``call_function`` node of an exported graph."""

    graph: str  # "" for the top graph, else the submodule's path
    name: str
    target: str  # e.g. "aten.sum.dim_IntList", "tpu_bfs_torch.ell_expand.default"
    dtypes: tuple  # the dtypes of the node's tensor outputs
    host_op: str | None  # why the node syncs with the host, or None
    new_bytes: int  # bytes it allocates (0 for a view or an in-place op)


@dataclasses.dataclass
class ProgramWalk:
    """What :func:`walk_program` read from one program."""

    nodes: list
    input_bytes: int  # every placeholder: user inputs and lifted constants
    output_bytes: int
    temp_peak_bytes: int  # the most intermediates live at once
    mutated_inputs: dict  # user-input placeholder name -> the ops writing it

    @property
    def peak_bytes(self) -> int:
        """Inputs resident, plus the intermediates' peak (outputs are
        intermediates live at the end)."""
        return self.input_bytes + self.temp_peak_bytes


def _tensors(val):
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _target_name(target) -> str:
    return str(target) if isinstance(target, torch._ops.OpOverload) else getattr(
        target, "__name__", str(target))


def _schema(target):
    return getattr(target, "_schema", None)


def _host_reason(node, target: str) -> str | None:
    """Why ``node`` is a host op, or None."""
    packet = target.rsplit(".", 1)[0]
    if target in HOST_SYNC_OPS or packet in HOST_SYNC_OPS:
        return "reads a device value on the host"
    if packet in _COPY_OPS:
        outs = _tensors(node.meta.get("val"))
        ins = [a for a in node.args if isinstance(a, torch.fx.Node)]
        src = _tensors(ins[0].meta.get("val")) if ins else []
        if outs and src and outs[0].device.type == "cpu" and src[0].device.type != "cpu":
            return "copies a device tensor to the CPU"
        return None
    fn = node.target
    if isinstance(fn, (torch._ops.OpOverload, torch._ops.OpOverloadPacket)):
        return None
    if isinstance(fn, torch._ops.HigherOrderOperator):
        return "calls back into Python" if "callback" in fn.__name__ else None
    module = getattr(fn, "__module__", "") or ""
    if module.split(".")[0] in _SYMBOLIC_MODULES or fn in vars(operator).values():
        return None
    return "calls back into Python"


def _graphs(ep):
    """(path, graph) of the program's graph and of every nested one."""
    for path, mod in ep.graph_module.named_modules():
        if isinstance(mod, torch.fx.GraphModule):
            yield path, mod.graph


def walk_program(ep) -> ProgramWalk:
    """Walk an ``ExportedProgram`` (module docstring)."""
    user_inputs = set(ep.graph_signature.user_inputs)
    nodes: list[NodeInfo] = []
    mutated: dict = {}
    for name in getattr(ep.graph_signature, "user_inputs_to_mutate", {}).values():
        mutated.setdefault(name, []).append("graph signature")
    input_bytes = output_bytes = temp_peak = 0
    for path, graph in _graphs(ep):
        order = list(graph.nodes)
        owner: dict = {}  # node -> the node whose storage it aliases
        alloc: dict = {}  # owner node -> its bytes (intermediates only)
        last_use: dict = {}
        for i, node in enumerate(order):
            for arg in node.all_input_nodes:
                last_use[owner.get(arg, arg)] = i
            if node.op == "placeholder":
                owner[node] = node
                if not path:
                    input_bytes += sum(_nbytes(t) for t in _tensors(node.meta.get("val")))
                continue
            if node.op == "output":
                if not path:
                    output_bytes = sum(
                        _nbytes(t) for a in node.all_input_nodes
                        for t in _tensors(a.meta.get("val")))
                continue
            if node.op != "call_function":
                owner[node] = node
                continue
            target = _target_name(node.target)
            schema = _schema(node.target)
            aliased = None
            if schema is not None:
                for arg_s, arg in zip(schema.arguments, node.args):
                    info = arg_s.alias_info
                    if info is None or not isinstance(arg, torch.fx.Node):
                        continue
                    base = owner.get(arg, arg)
                    if schema.returns and any(
                            r.alias_info is not None and r.alias_info.before_set
                            & info.before_set for r in schema.returns):
                        aliased = base
                    if info.is_write and base.op == "placeholder" and base.name in user_inputs:
                        mutated.setdefault(base.name, []).append(target)
            if node.target is operator.getitem and isinstance(node.args[0], torch.fx.Node):
                aliased = owner.get(node.args[0], node.args[0])
            outs = _tensors(node.meta.get("val"))
            new = 0 if aliased is not None else sum(_nbytes(t) for t in outs)
            owner[node] = aliased if aliased is not None else node
            if new:
                alloc[node] = new
            nodes.append(NodeInfo(path, node.name, target,
                                  tuple(str(t.dtype).removeprefix("torch.") for t in outs),
                                  _host_reason(node, target), new))
        # Liveness: an intermediate lives from its node to its last use
        # (through every view of it); the graph's outputs to the end.
        live = peak = 0
        ends: dict = {}
        for owner_node, nbytes in alloc.items():
            ends.setdefault(last_use.get(owner_node, len(order)), []).append(nbytes)
        for i, node in enumerate(order):
            live += alloc.get(node, 0)
            peak = max(peak, live)
            live -= sum(ends.get(i, ()))
        temp_peak = max(temp_peak, peak)
    return ProgramWalk(nodes, input_bytes, output_bytes, temp_peak, mutated)


def user_input_names(ep) -> list[str]:
    """The program's user-input placeholders, in argument order."""
    return list(ep.graph_signature.user_inputs)
