"""Program -> graphviz rendering (reference python/paddle/fluid/
net_drawer.py draw_graph): walks a Program's desc the same way
debugger.to_code does, emitting a styled dataflow graph through
graphviz.GraphPreviewGenerator. Usable as a module
(`python -m paddle_tpu_torch.fluid.net_drawer model.pb -o graph.dot`). A
copy of ``paddle_tpu/fluid/net_drawer.py``: the same dot text for the
same program."""
from __future__ import annotations

import argparse
from typing import Optional

from .framework import Parameter, Program
from .graphviz import GraphPreviewGenerator

__all__ = ["draw_graph", "draw_program"]


def draw_program(program: Program, title: str = "program",
                 block_idx: int = 0) -> GraphPreviewGenerator:
    """Build the preview graph for one block: ops as ellipses, params as
    filled boxes, temps dashed; edges follow the op input/output lists
    (reference net_drawer.parse_graph)."""
    g = GraphPreviewGenerator(title)
    block = program.block(block_idx)
    var_nodes = {}

    def var_node(name):
        if name in var_nodes:
            return var_nodes[name]
        var = block._var_recursive(name)
        shape = tuple(var.shape) if var is not None and var.shape else None
        dtype = var.dtype if var is not None else None
        if isinstance(var, Parameter):
            n = g.add_param(name, dtype, shape)
        else:
            n = g.add_var(name, dtype, shape)
        var_nodes[name] = n
        return n

    for op in block.ops:
        od = op.desc
        op_node = g.add_op(od.type)
        for name in od.input_names():
            if name:
                g.add_edge(var_node(name), op_node)
        for name in od.output_names():
            if name:
                g.add_edge(op_node, var_node(name))
    return g


def draw_graph(startup_program: Program, main_program: Program,
               dot_path: str = "graph.dot",
               image_path: Optional[str] = None, **kwargs):
    """reference net_drawer.py:draw_graph — renders the MAIN program (the
    startup program only carries initializers; the reference draws the
    same)."""
    g = draw_program(main_program, title=kwargs.get("graph_attr", {}).get(
        "label", "main_program") if isinstance(
            kwargs.get("graph_attr"), dict) else "main_program")
    g(dot_path, image_path)
    return g


def main():
    parser = argparse.ArgumentParser(
        description="render a serialized Program to graphviz dot")
    parser.add_argument("model", help="path to a serialized ProgramDesc "
                        "(Program.to_bytes output / __model__ file)")
    parser.add_argument("-o", "--output", default="graph.dot")
    parser.add_argument("--image", default=None)
    args = parser.parse_args()
    with open(args.model, "rb") as f:
        program = Program.parse_from_bytes(f.read())
    draw_program(program)(args.output, args.image)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
