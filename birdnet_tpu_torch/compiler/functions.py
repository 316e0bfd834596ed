"""Model-local ONNX function inlining.

ONNX IR ≥ 8 lets a model carry ``FunctionProto`` definitions — named
subgraph templates invoked by nodes whose ``(domain, op_type)`` match.
Producers like torch's dynamo exporter (onnxscript) and keras exporters
emit these heavily. The reference consumes them through ONNX Runtime's
function expansion (reference: src/classifier.rs:348-350 loads arbitrary
exporter output); here every call site is inlined at import time so the
rest of the compiler only ever sees plain nodes — under jit the expansion
is free (XLA fuses across the former call boundary).

Semantics implemented:
- call-site inputs/outputs bind to the function's formal inputs/outputs;
  internal values get fresh names (``__fn{N}_``-prefixed) so repeated
  calls never collide;
- attribute references (``AttributeProto.ref_attr_name``) resolve to the
  call-site attribute, falling back to the function's declared default
  (``attribute_proto``) and otherwise dropping the attribute so the op's
  own default applies — including inside nested If/Loop/Scan subgraphs;
- nested function calls expand iteratively (cycle-bounded);
- a function in the default domain never shadows a supported builtin op.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Tuple

from ..errors import ModelLoadError
from ..onnx.proto import (
    AttributeProto,
    AttrType,
    FunctionProto,
    GraphProto,
    NodeProto,
)

_MAX_EXPANSION_PASSES = 32


def _is_builtin(op_type: str) -> bool:
    from .ops import _REGISTRY

    return op_type in _REGISTRY


def function_table(
    functions: List[FunctionProto],
) -> Dict[Tuple[str, str], FunctionProto]:
    table: Dict[Tuple[str, str], FunctionProto] = {}
    for f in functions:
        table[(f.domain, f.name)] = f
    return table


def _resolve_attr(a: AttributeProto, call_attrs: Dict[str, AttributeProto],
                  defaults: Dict[str, AttributeProto]):
    """Resolve one function-body attribute against the call site.
    Returns the AttributeProto to use, or None to drop it."""
    if not a.ref_attr_name:
        return a
    site = call_attrs.get(a.ref_attr_name)
    if site is not None:
        # keep the body's attribute *name*, take the call site's payload
        return replace(site, name=a.name, ref_attr_name="")
    default = defaults.get(a.ref_attr_name)
    if default is not None and default.type != AttrType.UNDEFINED:
        return replace(default, name=a.name, ref_attr_name="")
    return None


def _rewrite_node(node: NodeProto, mapping: Dict[str, str],
                  call_attrs: Dict[str, AttributeProto],
                  defaults: Dict[str, AttributeProto]) -> NodeProto:
    """Rename a function-body node's values through ``mapping`` and resolve
    attribute references; recurses into subgraph attributes."""
    attrs = []
    for a in node.attribute:
        r = _resolve_attr(a, call_attrs, defaults)
        if r is None:
            continue
        if r.type == AttrType.GRAPH and r.g is not None:
            r = replace(r, g=_rewrite_subgraph(r.g, mapping, call_attrs, defaults))
        elif r.type == AttrType.GRAPHS and r.graphs:
            r = replace(
                r,
                graphs=[
                    _rewrite_subgraph(g, mapping, call_attrs, defaults)
                    for g in r.graphs
                ],
            )
        attrs.append(r)
    return NodeProto(
        op_type=node.op_type,
        name=node.name,
        domain=node.domain,
        input=[mapping.get(i, i) if i else "" for i in node.input],
        output=[mapping.get(o, o) if o else "" for o in node.output],
        attribute=attrs,
    )


def _rewrite_subgraph(g: GraphProto, outer_mapping: Dict[str, str],
                      call_attrs: Dict[str, AttributeProto],
                      defaults: Dict[str, AttributeProto]) -> GraphProto:
    """Apply the enclosing rename map to a nested subgraph.

    Names defined by the subgraph itself (formal inputs, initializers,
    node outputs) are local and shadow the outer scope; only references
    that escape to the enclosing function body are renamed. Attribute
    references resolve against the same call site everywhere in the body.
    """
    local = {vi.name for vi in g.input} | {t.name for t in g.initializer}
    for n in g.node:
        local.update(o for o in n.output if o)
    mapping = {k: v for k, v in outer_mapping.items() if k not in local}
    nodes = [_rewrite_node(n, mapping, call_attrs, defaults) for n in g.node]
    return replace(g, node=nodes)


def _expand_call(node: NodeProto, fn: FunctionProto, uid: int) -> List[NodeProto]:
    if len(node.input) > len(fn.input) or len(node.output) > len(fn.output):
        raise ModelLoadError(
            f"function call '{node.op_type}' passes {len(node.input)} inputs/"
            f"{len(node.output)} outputs but '{fn.name}' declares "
            f"{len(fn.input)}/{len(fn.output)}"
        )
    prefix = f"__fn{uid}_{fn.name}_"
    mapping: Dict[str, str] = {}
    for formal, actual in zip(fn.input, node.input):
        mapping[formal] = actual  # "" (absent optional) maps through as ""
    # trailing formals with no actual: absent optional inputs
    for formal in fn.input[len(node.input):]:
        mapping[formal] = ""
    for formal, actual in zip(fn.output, node.output):
        mapping[formal] = actual
    for formal in fn.output[len(node.output):]:
        mapping[formal] = prefix + formal  # unused trailing outputs
    for body_node in fn.node:
        for name in list(body_node.input) + list(body_node.output):
            if name and name not in mapping:
                mapping[name] = prefix + name
    call_attrs = {a.name: a for a in node.attribute}
    defaults = {a.name: a for a in fn.attribute_proto}
    return [
        _rewrite_node(n, mapping, call_attrs, defaults) for n in fn.node
    ]


def inline_functions(graph: GraphProto, functions: List[FunctionProto]) -> None:
    """Expand every model-local function call in ``graph`` (in place),
    including calls nested inside If/Loop/Scan subgraphs and calls that
    appear inside other functions' bodies."""
    if not functions:
        return
    table = function_table(functions)
    uid = [0]

    def expand_list(nodes: List[NodeProto]) -> Tuple[List[NodeProto], bool]:
        out: List[NodeProto] = []
        changed = False
        for n in nodes:
            fn = table.get((n.domain, n.op_type))
            if fn is not None and (
                n.domain not in ("", "ai.onnx") or not _is_builtin(n.op_type)
            ):
                uid[0] += 1
                out.extend(_expand_call(n, fn, uid[0]))
                changed = True
                continue
            # recurse into subgraph attributes for nested calls
            new_attrs = []
            node_changed = False
            for a in n.attribute:
                if a.type == AttrType.GRAPH and a.g is not None:
                    body, ch = expand_list(list(a.g.node))
                    if ch:
                        a = replace(a, g=replace(a.g, node=body))
                        node_changed = True
                elif a.type == AttrType.GRAPHS and a.graphs:
                    gs = []
                    for g in a.graphs:
                        body, ch = expand_list(list(g.node))
                        gs.append(replace(g, node=body) if ch else g)
                        node_changed = node_changed or ch
                    if node_changed:
                        a = replace(a, graphs=gs)
                new_attrs.append(a)
            if node_changed:
                n = replace(n, attribute=new_attrs)
                changed = True
            out.append(n)
        return out, changed

    for _ in range(_MAX_EXPANSION_PASSES):
        nodes, changed = expand_list(list(graph.node))
        graph.node[:] = nodes
        if not changed:
            return
    raise ModelLoadError(
        f"function expansion did not converge in {_MAX_EXPANSION_PASSES} "
        "passes (recursive model-local functions?)"
    )
