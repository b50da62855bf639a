"""Program graph drawing (counterpart of paddle_tpu/net_drawer.py).

Fluid walks ProgramDesc protobufs into a graphviz Graph; here the same walk
runs over the op list and writes ``.dot`` text (no graphviz needed).
"""
from .framework import default_main_program

__all__ = ['draw_graph', 'parse_graph', 'draw_node', 'draw_edge', 'unique_id']

OP_STYLE = {'shape': 'oval', 'color': '#0F9D58', 'style': 'filled'}
VAR_STYLE = {'shape': 'box'}

_counter = [0]


def unique_id():
    """Node ids, increasing over the process."""
    _counter[0] += 1
    return _counter[0]


def draw_node(op, node_id):
    """One graphviz node line for an op."""
    style = ', '.join(f'{k}="{v}"' for k, v in OP_STYLE.items())
    return f'op_{node_id} [label="{op.type}", {style}];'


def draw_edge(var_name, op_node_id, into_op=True):
    """One graphviz edge line between a var and an op."""
    v = f'"{var_name}"'
    return (f'{v} -> op_{op_node_id};' if into_op
            else f'op_{op_node_id} -> {v};')


def parse_graph(program, graph_lines, var_dict=None):
    """Append node and edge lines for every op of ``program``'s global
    block; returns {var name: the node id of the op that wrote it}."""
    var_dict = var_dict if var_dict is not None else {}
    for op in program.global_block().ops:
        nid = unique_id()
        graph_lines.append(draw_node(op, nid))
        for name in op.input_names():
            graph_lines.append(draw_edge(name, nid, into_op=True))
        for name in op.output_names():
            graph_lines.append(draw_edge(name, nid, into_op=False))
            var_dict[name] = nid
    return var_dict


def draw_graph(startup_program=None, main_program=None, path='graph.dot',
               graph_attr=None):
    """Write a .dot file of the startup and main programs; returns the
    text."""
    main_program = main_program or default_main_program()
    lines = ['digraph G {']
    if graph_attr:
        lines += [f'  {k}="{v}";' for k, v in graph_attr.items()]
    var_dict = {}
    if startup_program is not None:
        parse_graph(startup_program, lines, var_dict)
    parse_graph(main_program, lines, var_dict)
    lines.append('}')
    text = '\n'.join(lines)
    with open(path, 'w') as f:
        f.write(text)
    return text
