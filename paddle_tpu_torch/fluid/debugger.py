"""Program inspection tools (reference python/paddle/fluid/debuger.py and
net_drawer.py): a readable text dump of a Program and a graphviz .dot
rendering of a block's dataflow — a copy of
``paddle_tpu/fluid/debugger.py``, whose text and dot output the port's
equal for the same program."""
from __future__ import annotations

from typing import Optional

from .framework import Parameter, Program


def _fmt_var(var) -> str:
    kind = "param" if isinstance(var, Parameter) else "var"
    shape = tuple(var.shape) if var.shape is not None else "?"
    tags = []
    if var.persistable:
        tags.append("persist")
    if var.stop_gradient:
        tags.append("stopgrad")
    if var.lod_level:
        tags.append(f"lod={var.lod_level}")
    tag = (" [" + ",".join(tags) + "]") if tags else ""
    return f"    {kind} {var.name} : {var.dtype}{shape}{tag}"


def _fmt_io(io: dict) -> str:
    parts = []
    for slot, names in io.items():
        names = [n for n in names if n]
        if names:
            parts.append(f"{slot}=[{', '.join(names)}]")
    return ", ".join(parts)


def _fmt_attr(v):
    s = repr(v)
    return s if len(s) <= 60 else s[:57] + "..."


def to_code(program: Program, skip_op_callstack: bool = True) -> str:
    """Readable dump of every block (reference debuger.py pprint_program_codes
    / Program.to_string). Internal bookkeeping attrs (``__*``) are hidden."""
    lines = []
    for block in program.blocks:
        head = f"block {block.idx}"
        if block.parent_idx >= 0:
            head += f" (parent {block.parent_idx})"
        lines.append(head + " {")
        for name in sorted(block.vars):
            lines.append(_fmt_var(block.vars[name]))
        for op in block.ops:
            od = op.desc
            attrs = {
                k: v for k, v in od.attrs.items() if not k.startswith("__")
            }
            attr_str = (
                " {" + ", ".join(f"{k}={_fmt_attr(v)}"
                                 for k, v in sorted(attrs.items())) + "}"
                if attrs else ""
            )
            outs = _fmt_io(od.outputs)
            ins = _fmt_io(od.inputs)
            lines.append(f"    {outs or '()'} = {od.type}({ins}){attr_str}")
        lines.append("}")
    return "\n".join(lines)


def draw_block_graphviz(block, path: Optional[str] = None,
                        highlights=()) -> str:
    """Graphviz .dot source for a block's op/var dataflow (reference
    net_drawer.py / debuger.py draw_block_graphviz). Writes to `path` when
    given; always returns the dot text."""
    highlights = set(highlights)
    lines = ["digraph G {", "  rankdir=TB;"]
    var_nodes = {}

    def var_node(name):
        if name not in var_nodes:
            vid = f"v{len(var_nodes)}"
            var_nodes[name] = vid
            var = block._var_recursive(name)
            shape = tuple(var.shape) if var is not None and var.shape else ""
            color = "red" if name in highlights else (
                "lightblue" if isinstance(var, Parameter) else "white")
            lines.append(
                f'  {vid} [label="{name}\\n{shape}" shape=box '
                f'style=filled fillcolor={color}];')
        return var_nodes[name]

    for i, op in enumerate(block.ops):
        od = op.desc
        oid = f"op{i}"
        lines.append(
            f'  {oid} [label="{od.type}" shape=ellipse style=filled '
            f'fillcolor=palegreen];')
        for n in od.input_names():
            if n:
                lines.append(f"  {var_node(n)} -> {oid};")
        for n in od.output_names():
            if n:
                lines.append(f"  {oid} -> {var_node(n)};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
