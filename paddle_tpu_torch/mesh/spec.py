"""MeshSpec + ShardingRules: the serializable half of the mesh layer —
the counterpart of ``paddle_tpu/mesh/spec.py``.

A ``MeshSpec`` is the LOGICAL mesh — ordered named axes with sizes —
independent of any device handle, so it can ride a checkpoint manifest,
an RPC or a launcher's config verbatim. ``build()`` binds it to the
process group's ranks as a ``torch.distributed`` ``DeviceMesh`` with
these dim names. ``ShardingRules`` maps var/param NAMES to
PartitionSpecs with ordered first-match regex rules (name-based spec
assignment over dp/fsdp/tp axes) and speaks the ShardingPlan protocol
the ParallelExecutor consumes; each spec becomes DTensor placements
(``parallel.spec_to_placements``).
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.api import PartitionSpec as P, spec_to_placements

__all__ = ["MeshSpec", "ShardingRules", "transformer_rules",
           "decoder_rules", "flatten_param_names", "shard_param_tree"]

_AXIS_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class MeshSpec:
    """Named logical mesh axes, e.g. ``MeshSpec({'dp': 2, 'tp': 4})``.

    Axis ORDER matters (it is the device-array layout order); sizes are
    positive ints. Immutable after construction — every consumer
    (executor, engine, checkpoint) can hold a reference without
    defensive copies.
    """

    def __init__(self, axes: Dict[str, int]):
        if not axes:
            raise ValueError("MeshSpec needs at least one axis")
        clean: "OrderedDict[str, int]" = OrderedDict()
        for name, size in axes.items():
            name = str(name)
            if not _AXIS_RE.match(name):
                raise ValueError(
                    f"mesh axis name {name!r} is not an identifier")
            size = int(size)
            if size < 1:
                raise ValueError(
                    f"mesh axis {name!r} has size {size}; axes must be "
                    ">= 1")
            if name in clean:
                raise ValueError(f"duplicate mesh axis {name!r}")
            clean[name] = size
        self._axes = clean

    # -- views ------------------------------------------------------------
    @property
    def axes(self) -> "OrderedDict[str, int]":
        return OrderedDict(self._axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._axes)

    @property
    def size(self) -> int:
        return int(np.prod(list(self._axes.values()), dtype=np.int64))

    def axis_size(self, name: str) -> int:
        if name not in self._axes:
            raise KeyError(f"mesh has no axis {name!r}; axes: "
                           f"{dict(self._axes)}")
        return self._axes[name]

    def __contains__(self, name: str) -> bool:
        return name in self._axes

    def __eq__(self, other) -> bool:
        return isinstance(other, MeshSpec) and \
            list(self._axes.items()) == list(other._axes.items())

    def __hash__(self):
        return hash(tuple(self._axes.items()))

    def __repr__(self) -> str:
        return f"MeshSpec({dict(self._axes)})"

    # -- parse / serialize -------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        """``"dp=2,tp=2,fsdp=2"`` -> MeshSpec (the FLAGS['mesh_axes'] /
        CLI spelling). Whitespace-tolerant; typed errors name the bad
        piece."""
        axes: "OrderedDict[str, int]" = OrderedDict()
        for piece in str(text).split(","):
            piece = piece.strip()
            if not piece:
                continue
            if "=" not in piece:
                raise ValueError(
                    f"mesh axis {piece!r} is not 'name=size' (full spec "
                    f"text: {text!r})")
            name, _, size = piece.partition("=")
            name = name.strip()
            if name in axes:
                # catch here: the dict would silently keep one entry
                # and __init__ could never see the duplicate
                raise ValueError(f"duplicate mesh axis {name!r}")
            try:
                axes[name] = int(size.strip())
            except ValueError:
                raise ValueError(
                    f"mesh axis {piece!r} has a non-integer size") \
                    from None
        return cls(axes)

    @classmethod
    def coerce(cls, value) -> "MeshSpec":
        """Accept a MeshSpec, an axes dict, or the 'dp=2,tp=4' string —
        the one rule every mesh= parameter in the repo applies."""
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, str):
            return cls.parse(value)
        raise TypeError(
            f"cannot build a MeshSpec from {type(value).__name__}; pass "
            "a MeshSpec, an axes dict, or a 'dp=2,tp=4' string")

    def to_dict(self) -> Dict[str, Any]:
        return {"axes": [[n, s] for n, s in self._axes.items()]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MeshSpec":
        axes = d.get("axes")
        if not isinstance(axes, (list, tuple)):
            raise ValueError(f"malformed MeshSpec dict {d!r}")
        return cls(OrderedDict((str(n), int(s)) for n, s in axes))

    def __str__(self) -> str:
        return ",".join(f"{n}={s}" for n, s in self._axes.items())

    # -- device binding ----------------------------------------------------
    def build(self, devices=None):
        """Bind to the process group's ranks -> a ``DeviceMesh`` with these
        axis names (``init_device_mesh``). ``devices`` is the device type
        (``"cuda"``, the default, or ``"cpu"``) or a ``torch.device``. The
        mesh's size must equal the world size (one rank a device; a mesh
        of one device starts its own one-rank group when none is
        initialized); a mismatch is a typed error naming both."""
        from ..parallel.api import make_mesh

        return make_mesh(self.axes, devices=devices)


# --- sharding rules ------------------------------------------------------

def _spec_to_json(spec: P) -> List[Any]:
    out: List[Any] = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(a) for a in e])
        else:
            out.append(str(e))
    return out


def _spec_from_json(entry) -> P:
    dims = []
    for e in entry:
        if e is None:
            dims.append(None)
        elif isinstance(e, (tuple, list)):
            dims.append(tuple(str(a) for a in e))
        else:
            dims.append(str(e))
    return P(*dims)


def _spec_axes(spec: P):
    for e in tuple(spec):
        if e is None:
            continue
        if isinstance(e, (tuple, list)):
            for a in e:
                yield str(a)
        else:
            yield str(e)


class ShardingRules:
    """Ordered (regex, PartitionSpec) rules over var/param names; first
    match wins, unmatched names replicate.

    Speaks the plan protocol ``ParallelExecutor`` consumes
    (``spec_for(name, ndim)`` / ``feed_spec(ndim)`` / ``batch_axis`` /
    ``seq_axis`` / ``best_effort``) plus JSON serialization so a rule
    set travels with its artifact. A rule whose spec has more dims than
    the var replicates it (scalar optimizer accumulators derived from a
    param name can't take the param's spec — the ShardingPlan
    convention). Immutable after construction: ``with_rule`` returns a
    new object, so shared references (executor + checkpoint writer +
    statusz) never race a mutation.
    """

    def __init__(self, rules: Sequence[Tuple[str, P]] = (),
                 batch_axis: Optional[str] = "dp",
                 seq_axis: Optional[str] = None,
                 best_effort: bool = True,
                 mesh_spec: Optional[MeshSpec] = None):
        compiled = []
        for pat, spec in rules:
            if not isinstance(spec, P):
                spec = _spec_from_json(spec)
            if mesh_spec is not None:
                for ax in _spec_axes(spec):
                    if ax not in mesh_spec:
                        raise ValueError(
                            f"rule {pat!r} names axis {ax!r} which mesh "
                            f"{mesh_spec} does not have")
            compiled.append((str(pat), re.compile(str(pat)), spec))
        self._rules = tuple(compiled)
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        # best_effort (default ON — the plan_fsdp convention): an
        # indivisible dim replicates instead of erroring, so odd-width
        # biases and class-count tails survive any mesh
        self.best_effort = bool(best_effort)

    # -- plan protocol -----------------------------------------------------
    def spec_for(self, name: str, ndim: int) -> P:
        for _, pat, spec in self._rules:
            if pat.search(name):
                if len(spec) > ndim:
                    return P()
                return spec
        return P()

    def feed_spec(self, ndim: int) -> P:
        if self.batch_axis is None or ndim == 0:
            return P()
        if self.seq_axis is not None and ndim >= 2:
            return P(self.batch_axis, self.seq_axis, *([None] * (ndim - 2)))
        return P(self.batch_axis, *([None] * (ndim - 1)))

    # -- construction / serialization -------------------------------------
    def with_rule(self, pattern: str, spec: P) -> "ShardingRules":
        """A new rules object with ``pattern -> spec`` appended (lowest
        priority: earlier rules still win)."""
        rules = [(src, spec_) for src, _, spec_ in self._rules]
        rules.append((pattern, spec))
        return ShardingRules(rules, batch_axis=self.batch_axis,
                             seq_axis=self.seq_axis,
                             best_effort=self.best_effort)

    @property
    def rules(self) -> List[Tuple[Any, P]]:
        """(compiled_pattern, spec) pairs — the ShardingPlan view."""
        return [(pat, spec) for _, pat, spec in self._rules]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rules": [[src, _spec_to_json(spec)]
                      for src, _, spec in self._rules],
            "batch_axis": self.batch_axis,
            "seq_axis": self.seq_axis,
            "best_effort": self.best_effort,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShardingRules":
        return cls([(str(src), _spec_from_json(spec))
                    for src, spec in d.get("rules", [])],
                   batch_axis=d.get("batch_axis"),
                   seq_axis=d.get("seq_axis"),
                   best_effort=bool(d.get("best_effort", True)))

    @classmethod
    def coerce(cls, value, default=None) -> "ShardingRules":
        """The one rules-coercion rule every mesh_rules= parameter in
        the repo applies: None -> ``default()`` (a zero-arg factory,
        e.g. ``decoder_rules``), a dict -> ``from_dict`` (the wire/
        manifest form), a ShardingRules passes through."""
        if value is None:
            if default is None:
                raise TypeError("mesh rules required (no default)")
            return default()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls.from_dict(value)
        raise TypeError(
            f"cannot build ShardingRules from {type(value).__name__}; "
            "pass a ShardingRules, its to_dict() form, or None")

    def __repr__(self) -> str:
        return (f"ShardingRules({len(self._rules)} rules, "
                f"batch_axis={self.batch_axis!r})")


# --- stock rule sets -----------------------------------------------------

def transformer_rules(dp: str = "dp", fsdp: str = "fsdp", tp: str = "tp"
                      ) -> ShardingRules:
    """dp x tp x fsdp rules for ``models/transformer.py`` param names
    (the SNIPPETS [2] shape: qkv/ff1 column-parallel over tp, out/ff2
    row-parallel, embeddings vocab-sharded — each ALSO dim-sharded over
    fsdp, the ZeRO axis, so per-chip param+optimizer memory divides by
    |fsdp| while DTensor all-gathers at use). The ``(_\\w+)?$`` tails
    keep Adam/Momentum accumulators sharded alongside their params;
    scalar accumulators replicate via the ndim guard; layer norms
    best-effort-shard dim 0 over fsdp."""
    return ShardingRules(
        rules=[
            (r"\.(q|k|v)\.w(_\w+)?$", P(fsdp, tp)),
            (r"\.ff1\.w(_\w+)?$", P(fsdp, tp)),
            (r"\.out\.w(_\w+)?$", P(tp, fsdp)),
            (r"\.ff2\.w(_\w+)?$", P(tp, fsdp)),
            (r"\.emb(_\w+)?$", P(tp, fsdp)),
            (r"^proj\.w(_\w+)?$", P(fsdp, tp)),
            (r"\.ln\.(scale|bias)(_\w+)?$", P(fsdp)),
            # catch-all FSDP: any remaining tensor shards dim 0 over
            # fsdp (best_effort replicates what cannot divide)
            (r".", P(fsdp)),
        ],
        batch_axis=dp,
    )


def decoder_rules(tp: str = "tp") -> ShardingRules:
    """Tensor-parallel rules for the serving decoder's param tree
    (``build_decoder_params`` names under the checkpoint ``_flatten``
    scheme). Attention projections are column-parallel over tp — wk/wv
    shard the KV-HEAD axis, which is exactly how the paged KV pool
    shards (``[layers, pages, page_size, kv_heads, head_dim]`` over dim
    3) — wo/w2 are row-parallel, the embedding shards its vocab rows.
    Layer norms replicate (tiny, and the ln reduction is over the
    unsharded feature dim)."""
    return ShardingRules(
        rules=[
            (r"/w[qkv]$", P(None, tp)),
            (r"/wo$", P(tp, None)),
            (r"/w1$", P(None, tp)),
            (r"/w2$", P(tp, None)),
            (r"^tok_emb$", P(tp, None)),
        ],
        batch_axis=None,
    )


# --- param-tree helpers --------------------------------------------------

def flatten_param_names(tree, prefix: str = ""):
    """Yield ``(flat_name, leaf)`` pairs under the checkpoint
    ``_flatten`` naming scheme (dict keys and tuple/list indices joined
    with '/'), so ShardingRules written against checkpoint names apply
    to live param trees identically."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_param_names(v, f"{prefix}{k}/")
        return
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flatten_param_names(v, f"{prefix}{i}/")
        return
    yield prefix[:-1] if prefix.endswith("/") else prefix, tree


def _tree_map_named(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_map_named(v, fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map_named(v, fn, f"{prefix}{i}/")
                     for i, v in enumerate(tree))
    if isinstance(tree, list):
        return [_tree_map_named(v, fn, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1] if prefix.endswith("/") else prefix, tree)


def shard_param_tree(tree, mesh, rules: ShardingRules,
                     src_data_rank: Optional[int] = 0):
    """``distribute_tensor`` (from rank ``src_data_rank``; None: each rank
    cuts its shards from its own copy, no collective) every leaf of a
    param tree per its name-matched rule over ``mesh`` (a ``DeviceMesh``
    with dim names). Indivisible dims replicate when ``rules.best_effort`` (else a
    typed error naming the tensor) — the ParallelExecutor divisibility
    discipline applied to param trees. Returns the same tree structure
    with DTensors on the mesh's device type."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, (int(s) for s in mesh.shape)))

    def _divisible(shape, spec):
        for dim, ax in enumerate(tuple(spec)):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = int(np.prod([sizes.get(a, 1) for a in axes]))
            if dim >= len(shape) or shape[dim] % size != 0:
                return False
        return True

    def put(name, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else \
            torch.as_tensor(np.asarray(leaf))
        spec = rules.spec_for(name, t.ndim)
        for ax in _spec_axes(spec):
            if ax not in sizes:
                raise ValueError(
                    f"param '{name}' rule names axis {ax!r} which mesh "
                    f"axes {sizes} do not have")
        if not _divisible(tuple(t.shape), spec):
            if not rules.best_effort:
                raise ValueError(
                    f"param '{name}' (shape {tuple(t.shape)}) does "
                    f"not divide over spec {spec} of mesh {sizes}")
            spec = P()
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 spec_to_placements(spec, names),
                                 src_data_rank=src_data_rank)

    return _tree_map_named(tree, put)
