"""The dataflow graph of Model Function Calls (MFCs) (the port's copy of
``areal_tpu/api/dfg.py``). An
experiment is a small DAG of MFCs — e.g. PPO: actor.generate →
{rew.inference, ref.inference, critic.inference} → {actor.train_step,
critic.train_step} — whose edges are induced by key production/consumption.
The master worker traverses this graph once per training step; data
dependencies are resolved through the sequence buffer, so the graph here
only needs parents/children and hook metadata.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Set, Tuple

from areal_tpu_torch.api.config import ModelFamily
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import ModelName


class ModelInterfaceType(enum.Enum):
    GENERATE = "generate"
    TRAIN_STEP = "train_step"
    INFERENCE = "inference"
    EVALUATE = "evaluate"


@dataclasses.dataclass
class OffloadHook:
    """Move params to host memory after the MFC."""


@dataclasses.dataclass
class ParamReallocHook:
    """Resharding weights from/to another model replica around an MFC."""

    source: Optional[ModelName] = None
    target: Optional[ModelName] = None
    eta: float = 1.0  # EMA coefficient: new = eta * src + (1 - eta) * dst


@dataclasses.dataclass
class SaveHook:
    pass


@dataclasses.dataclass
class EvaluateHook:
    pass


@dataclasses.dataclass
class MFCDef:
    """One model function call in the dataflow graph.

    name: unique MFC name (e.g. 'actor_gen', 'actor_train').
    model_name: which model replica executes it.
    interface_type/interface_impl: what to run and with which algorithm
        implementation (resolved via the interface registry).
    n_seqs: how many sequences this MFC consumes per step (the train batch
        size for the root MFCs).
    input_keys/output_keys: data keys consumed/produced; edges of the DFG
        are derived from these.
    input_key_remap/output_key_remap: rename keys on the way in/out.
    mb_spec: micro-batch splitting spec for this call.
    balanced_dp: split the batch across DP groups by equal sequence count
        rather than token count (generation dispatch).
    min_n_seqs_per_pass: require at least this many seqs per model pass
        (e.g. PPO minibatching: n_seqs / n_mbs per update).
    """

    name: str
    model_name: ModelName
    interface_type: ModelInterfaceType
    interface_impl: Any
    n_seqs: int = 1
    input_keys: Tuple[str, ...] = ()
    output_keys: Tuple[str, ...] = ()
    input_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    output_key_remap: Dict[str, str] = dataclasses.field(default_factory=dict)
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    balanced_dp: bool = False
    log_return_value: bool = False
    min_n_seqs_per_pass: float = 1
    model_type: Optional[ModelFamily] = None
    model_path: Optional[str] = None
    pre_hooks: List[Any] = dataclasses.field(default_factory=list)
    post_hooks: List[Any] = dataclasses.field(default_factory=list)

    # Filled by build_graph:
    _parents: List[str] = dataclasses.field(default_factory=list)
    _children: List[str] = dataclasses.field(default_factory=list)
    _G: Optional["DFGraph"] = None

    def __post_init__(self):
        self.input_keys = tuple(self.input_keys)
        self.output_keys = tuple(self.output_keys)

    @property
    def role(self) -> str:
        return self.model_name.role

    @property
    def is_src(self) -> bool:
        return not self._parents

    @property
    def is_dst(self) -> bool:
        return not self._children

    @property
    def parents(self) -> List[str]:
        return list(self._parents)

    @property
    def children(self) -> List[str]:
        return list(self._children)

    def produced_key(self, key: str) -> str:
        """External name of an output key after remapping."""
        return self.output_key_remap.get(key, key)

    def add_pre_hook(self, hook):
        self.pre_hooks.append(hook)

    def add_post_hook(self, hook):
        self.post_hooks.append(hook)

    def __repr__(self):
        return f"MFCDef({self.name}, {self.interface_type.value}@{self.model_name})"


@dataclasses.dataclass
class DFGraph:
    rpcs: Dict[str, MFCDef]
    # key -> producing MFC name (None if supplied by the dataset)
    producers: Dict[str, Optional[str]]
    topo_order: List[List[str]]  # levels of the DAG

    def topological_levels(self) -> List[List[MFCDef]]:
        return [[self.rpcs[n] for n in level] for level in self.topo_order]

    @property
    def data_keys(self) -> Set[str]:
        """Keys that must come from the dataset (no MFC produces them)."""
        return {k for k, p in self.producers.items() if p is None}


def build_graph(rpcs: List[MFCDef], verbose: bool = False) -> DFGraph:
    """Wire parents/children from key production/consumption and
    topologically sort. Raises on duplicate producers or cycles."""
    by_name = {r.name: r for r in rpcs}
    if len(by_name) != len(rpcs):
        raise ValueError("duplicate MFC names")

    produced: Dict[str, str] = {}
    for r in rpcs:
        for k in r.output_keys:
            ext = r.produced_key(k)
            if ext in produced:
                raise ValueError(
                    f"key {ext!r} produced by both {produced[ext]} and {r.name}"
                )
            produced[ext] = r.name

    producers: Dict[str, Optional[str]] = {}
    for r in rpcs:
        r._parents.clear()
        r._children.clear()
    for r in rpcs:
        for k in r.input_keys:
            src = produced.get(k)
            producers.setdefault(k, src)
            if src is not None and src != r.name:
                if src not in r._parents:
                    r._parents.append(src)
                if r.name not in by_name[src]._children:
                    by_name[src]._children.append(r.name)
    for k, src in produced.items():
        producers.setdefault(k, src)

    # Kahn levels.
    indeg = {r.name: len(r._parents) for r in rpcs}
    levels: List[List[str]] = []
    remaining = set(by_name)
    frontier = sorted([n for n in remaining if indeg[n] == 0])
    while frontier:
        levels.append(frontier)
        remaining -= set(frontier)
        nxt = []
        for n in frontier:
            for c in by_name[n]._children:
                indeg[c] -= 1
                if indeg[c] == 0:
                    nxt.append(c)
        frontier = sorted(set(nxt))
    if remaining:
        raise ValueError(f"cycle in MFC graph involving: {sorted(remaining)}")

    g = DFGraph(rpcs=by_name, producers=producers, topo_order=levels)
    for r in rpcs:
        r._G = g
    return g
