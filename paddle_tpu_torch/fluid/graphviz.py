"""Small graphviz dot-building API (reference python/paddle/fluid/
graphviz.py: Graph/Node/Edge + GraphPreviewGenerator). Pure text emission —
rendering to an image shells out to the `dot` binary only when present
(codegen works headless; the reference behaves the same way). A copy of
``paddle_tpu/fluid/graphviz.py``."""
from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict, List, Optional

__all__ = ["Node", "Edge", "Graph", "GraphPreviewGenerator"]


def _attr_str(attrs: Dict[str, Any]) -> str:
    if not attrs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(attrs.items()))
    return f" [{body}]"


class Node:
    counter = 0

    def __init__(self, label: str, prefix: str, **attrs):
        Node.counter += 1
        self.id = f"{prefix}_{Node.counter}"
        self.label = label
        self.attrs = dict(attrs)

    def __str__(self):
        extra = "".join(f',{k}="{v}"' for k, v in sorted(self.attrs.items()))
        return f'{self.id} [label="{self.label}"{extra}]'


class Edge:
    def __init__(self, source: Node, target: Node, **attrs):
        self.source = source
        self.target = target
        self.attrs = dict(attrs)

    def __str__(self):
        return f"{self.source.id} -> {self.target.id}{_attr_str(self.attrs)}"


class Graph:
    def __init__(self, title: str, rankdir: str = "TB", **attrs):
        self.title = title
        self.rankdir = rankdir
        self.attrs = dict(attrs)
        self.nodes: List[Node] = []
        self.edges: List[Edge] = []
        self.rank_groups: Dict[str, List[Node]] = {}

    def node(self, label: str, prefix: str = "n", **attrs) -> Node:
        n = Node(label, prefix, **attrs)
        self.nodes.append(n)
        return n

    def edge(self, source: Node, target: Node, **attrs) -> Edge:
        e = Edge(source, target, **attrs)
        self.edges.append(e)
        return e

    def rank_group(self, kind: str, node: Node):
        self.rank_groups.setdefault(kind, []).append(node)

    def code(self) -> str:
        lines = [f'digraph "{self.title}" {{', f"  rankdir={self.rankdir};"]
        for k, v in sorted(self.attrs.items()):
            lines.append(f'  {k}="{v}";')
        for n in self.nodes:
            lines.append(f"  {n};")
        for kind, nodes in self.rank_groups.items():
            ids = "; ".join(n.id for n in nodes)
            lines.append(f'  {{ rank={kind}; {ids}; }}')
        for e in self.edges:
            lines.append(f"  {e};")
        lines.append("}")
        return "\n".join(lines)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.code())
        return path

    def display(self, dot_path: str, image_path: Optional[str] = None):
        """Write the .dot file; render it when the `dot` binary exists
        (reference Graph.show). Returns the image path or None."""
        self.save(dot_path)
        if image_path and shutil.which("dot"):
            subprocess.run(["dot", "-Tpng", dot_path, "-o", image_path],
                           check=False)
            return image_path
        return None


class GraphPreviewGenerator:
    """Styled wrapper (reference graphviz.py GraphPreviewGenerator): params
    as filled boxes, ops as ellipses, plain vars as dashed boxes."""

    def __init__(self, title: str):
        self.graph = Graph(title, rankdir="TB")

    def add_param(self, name: str, dtype=None, shape=None) -> Node:
        label = "\\n".join(str(p) for p in (name, dtype, shape)
                           if p is not None)
        return self.graph.node(label, prefix="param", shape="box",
                               style="filled", fillcolor="lightblue")

    def add_op(self, opType: str) -> Node:
        return self.graph.node(opType, prefix="op", shape="ellipse",
                               style="filled", fillcolor="palegreen")

    def add_var(self, name: str, dtype=None, shape=None) -> Node:
        label = "\\n".join(str(p) for p in (name, dtype, shape)
                           if p is not None)
        return self.graph.node(label, prefix="var", shape="box",
                               style="dashed")

    def add_edge(self, source: Node, target: Node, **attrs) -> Edge:
        return self.graph.edge(source, target, **attrs)

    def __call__(self, dot_path: str, image_path: Optional[str] = None):
        return self.graph.display(dot_path, image_path)
