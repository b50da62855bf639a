"""Weights between the JAX package's layout and the port's.

The JAX model's ``named_parameters()`` names and torch's ``state_dict()``
names are the same (``blocks.0.attn.q.weight``,
``bert.encoder.0.attn.q.weight``, ...); only the layout of the Linear weights
differs: Paddle's ``Linear`` stores (in, out), torch's ``nn.Linear``
(out, in). Embeddings (V, H), LayerNorm scale and bias and BERT's
``heads.decoder_bias`` keep their layout.

- ``TransformerLM``: :func:`expected_shapes`, :func:`state_dict_from_paddle`,
  :func:`init_params`.
- ``BertForPretraining``: :func:`bert_expected_shapes`,
  :func:`bert_state_dict_from_paddle`, :func:`bert_init_params`. The MLM
  decoder is tied to ``bert.word_emb.weight``, so one tensor is loaded for
  both.
- ``ResNet``: :func:`resnet_expected_shapes`,
  :func:`resnet_state_dict_from_paddle`, :func:`resnet_init_params`. The
  names cover the parameters and BatchNorm's running-statistics buffers.
  The port's conv weights are OIHW whatever the data format: an NHWC
  checkpoint's HWIO weights are transposed, an NCHW one's are OIHW
  already; ``out.weight`` goes from (in, out) to (out, in); BatchNorm's
  parameters and buffers keep their layout.
- The static graph: :func:`scope_from_paddle` copies a JAX scope's
  persistables into the port's scope by name. Static parameters share
  Paddle's layouts in both packages (``mul`` weights (in, out), conv OIHW),
  so nothing is relaid out.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['expected_shapes', 'state_dict_from_paddle', 'init_params',
           'bert_expected_shapes', 'bert_state_dict_from_paddle',
           'bert_init_params', 'resnet_expected_shapes',
           'resnet_state_dict_from_paddle', 'resnet_init_params',
           'scope_from_paddle']

_LINEARS = ('attn.q', 'attn.k', 'attn.v', 'attn.out', 'ffn1', 'ffn2')
_BERT_LINEARS = _LINEARS + ('bert.pooler', 'heads.transform', 'heads.nsp')


def _block_shapes(h, f, prefix):
    """{name: shape} of one TransformerLayer under ``prefix``, Paddle
    layout, in the JAX model's order."""
    # (sublayer, Linear (in, out) or None for a LayerNorm), in layer order
    subs = (('attn.q', (h, h)), ('attn.k', (h, h)), ('attn.v', (h, h)),
            ('attn.out', (h, h)), ('attn_ln', None), ('ffn1', (h, f)),
            ('ffn2', (f, h)), ('ffn_ln', None))
    shapes = {}
    for sub, io in subs:
        shapes[f'{prefix}{sub}.weight'] = io if io else (h,)
        shapes[f'{prefix}{sub}.bias'] = (io[1],) if io else (h,)
    return shapes


def expected_shapes(cfg):
    """{name: shape} of a ``TransformerLM(cfg)``'s parameters in Paddle
    layout, in the JAX model's ``named_parameters()`` order."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {'word_emb.weight': (cfg.vocab_size, h),
              'pos_emb.weight': (cfg.max_position_embeddings, h),
              'emb_ln.weight': (h,), 'emb_ln.bias': (h,)}
    for i in range(cfg.num_hidden_layers):
        shapes.update(_block_shapes(h, f, f'blocks.{i}.'))
    return shapes


def _infer_shapes(named_numpy):
    """The expected {name: shape} for the model these arrays describe: vocab,
    width and positions from the embeddings, depth from the highest block
    index, FFN width from block 0."""
    from .models.causal_lm import CausalLMConfig
    return expected_shapes(CausalLMConfig(**_infer_dims(named_numpy, '')))


def _infer_dims(named_numpy, prefix):
    """Vocab, width, positions, depth and FFN width of the model whose
    Paddle-layout arrays these are; ``prefix`` is ``'bert.'`` for BERT,
    whose blocks are ``encoder.N``, else the LM's ``blocks.N``."""
    blocks = prefix + ('encoder.' if prefix else 'blocks.')
    ffn1 = blocks + '0.ffn1.weight'
    for name in (prefix + 'word_emb.weight', prefix + 'pos_emb.weight', ffn1):
        if name not in named_numpy:
            raise KeyError(f'missing parameter(s): {name}')
    vocab, hidden = np.shape(named_numpy[prefix + 'word_emb.weight'])
    depth = len(blocks.split('.')) - 1
    layers = 1 + max(int(n.split('.')[depth]) for n in named_numpy
                     if n.startswith(blocks)
                     and n.split('.')[depth].isdigit())
    return {'vocab_size': vocab, 'hidden_size': hidden,
            'num_hidden_layers': layers, 'num_attention_heads': 1,
            'intermediate_size': np.shape(named_numpy[ffn1])[1],
            'max_position_embeddings':
                np.shape(named_numpy[prefix + 'pos_emb.weight'])[0]}


def state_dict_from_paddle(named_numpy):
    """Paddle-layout ``{name: ndarray}`` (the JAX model's
    ``named_parameters()`` as numpy) -> a torch state dict for
    ``TransformerLM``: Linear weights transposed from (in, out) to (out, in),
    everything else as it is, all f32. Raises on an unknown or missing name
    and on a shape that does not match the model the embeddings and block
    0 describe."""
    return _to_state_dict(named_numpy, _infer_shapes(named_numpy), _LINEARS)


def _to_state_dict(named_numpy, shapes, linears, relayout=None):
    """Check names and Paddle-layout shapes, then transpose the Linear
    weights named by ``linears`` and apply ``relayout(name, arr)`` (if
    given) to every array."""
    unknown = sorted(set(named_numpy) - set(shapes))
    missing = sorted(set(shapes) - set(named_numpy))
    if unknown:
        raise KeyError(f'unknown parameter name(s): {", ".join(unknown)}')
    if missing:
        raise KeyError(f'missing parameter(s): {", ".join(missing)}')
    out = {}
    for name, arr in named_numpy.items():
        arr = np.asarray(arr, dtype=np.float32)
        if arr.shape != shapes[name]:
            raise ValueError(f'{name}: shape {arr.shape} != expected '
                             f'{shapes[name]}')
        if any(name == f'{lin}.weight' or name.endswith(f'.{lin}.weight')
               for lin in linears):
            arr = arr.T
        if relayout is not None:
            arr = relayout(name, arr)
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out


def init_params(cfg, seed):
    """Seeded Paddle-layout parameters for ``TransformerLM(cfg)`` built on
    numpy: embeddings and Linear weights from a normal truncated at two
    standard deviations with std ``cfg.initializer_range`` (the
    distribution of the JAX model's TruncatedNormalInitializer, not its
    bits), Linear biases 0, LayerNorm scale 1 and bias 0."""
    return _init(expected_shapes(cfg), cfg.initializer_range, seed)


def _init(shapes, std, seed):
    rng = np.random.default_rng(int(seed))
    std = float(std)
    out = {}
    for name, shape in shapes.items():
        if name.endswith('bias'):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith('_ln.weight'):
            out[name] = np.ones(shape, np.float32)
        else:
            x = rng.standard_normal(shape)
            bad = np.abs(x) > 2.0
            while bad.any():              # resample outside [-2, 2]
                x[bad] = rng.standard_normal(int(bad.sum()))
                bad = np.abs(x) > 2.0
            out[name] = (x * std).astype(np.float32)
    return out


def bert_expected_shapes(cfg):
    """{name: shape} of a ``BertForPretraining(cfg)``'s parameters in Paddle
    layout, in the JAX model's ``named_parameters()`` order."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {'bert.word_emb.weight': (v, h),
              'bert.pos_emb.weight': (cfg.max_position_embeddings, h),
              'bert.type_emb.weight': (cfg.type_vocab_size, h),
              'bert.emb_ln.weight': (h,), 'bert.emb_ln.bias': (h,)}
    for i in range(cfg.num_hidden_layers):
        shapes.update(_block_shapes(h, f, f'bert.encoder.{i}.'))
    shapes.update({'bert.pooler.weight': (h, h), 'bert.pooler.bias': (h,),
                   'heads.decoder_bias': (v,),
                   'heads.transform.weight': (h, h),
                   'heads.transform.bias': (h,),
                   'heads.transform_ln.weight': (h,),
                   'heads.transform_ln.bias': (h,),
                   'heads.nsp.weight': (h, 2), 'heads.nsp.bias': (2,)})
    return shapes


def bert_state_dict_from_paddle(named_numpy):
    """Paddle-layout ``{name: ndarray}`` (the JAX ``BertForPretraining``'s
    ``named_parameters()`` as numpy) -> a torch state dict for the port's
    ``BertForPretraining``: the Linear weights (``attn.q/k/v/out``,
    ``ffn1``, ``ffn2``, ``bert.pooler``, ``heads.transform``,
    ``heads.nsp``) transposed from (in, out) to (out, in); embeddings,
    LayerNorm parameters and ``heads.decoder_bias`` as they are; all f32.
    Raises on an unknown or missing name and on a shape that does not match
    the model the embeddings and block 0 describe."""
    from .models.bert import BertConfig
    if 'bert.type_emb.weight' not in named_numpy:
        raise KeyError('missing parameter(s): bert.type_emb.weight')
    cfg = BertConfig(
        **_infer_dims(named_numpy, 'bert.'),
        type_vocab_size=np.shape(named_numpy['bert.type_emb.weight'])[0])
    return _to_state_dict(named_numpy, bert_expected_shapes(cfg),
                          _BERT_LINEARS)


def bert_init_params(cfg, seed):
    """Seeded Paddle-layout parameters for ``BertForPretraining(cfg)``, as
    :func:`init_params` makes them: embeddings and Linear weights truncated
    normal with std ``cfg.initializer_range``, Linear biases and
    ``heads.decoder_bias`` 0, LayerNorm scale 1 and bias 0."""
    return _init(bert_expected_shapes(cfg), cfg.initializer_range, seed)


# depth -> blocks per stage, bottleneck (expansion 4) or basic blocks
_RESNET_DEPTHS = {18: ((2, 2, 2, 2), False), 34: ((3, 4, 6, 3), False),
                  50: ((3, 4, 6, 3), True), 101: ((3, 4, 23, 3), True),
                  152: ((3, 8, 36, 3), True)}


def _conv_bn_shapes(prefix, cin, cout, k, data_format):
    w = (k, k, cin, cout) if data_format == 'NHWC' else (cout, cin, k, k)
    return {f'{prefix}._conv.weight': w, f'{prefix}._bn.weight': (cout,),
            f'{prefix}._bn.bias': (cout,), f'{prefix}._bn._mean_buf': (cout,),
            f'{prefix}._bn._variance_buf': (cout,)}


def resnet_expected_shapes(depth, class_dim, data_format):
    """{name: shape} of a ``ResNet(depth, class_dim, data_format)``'s
    parameters and BatchNorm buffers in Paddle layout (conv weights HWIO
    for NHWC, OIHW for NCHW; ``out.weight`` (in, out)): the JAX model's
    ``named_parameters()`` in order, then its ``named_buffers()`` in
    order."""
    if depth not in _RESNET_DEPTHS:
        raise ValueError(f'depth must be one of {sorted(_RESNET_DEPTHS)}, '
                         f'got {depth}')
    if data_format not in ('NCHW', 'NHWC'):
        raise ValueError(f'data_format must be NCHW or NHWC, got '
                         f'{data_format!r}')
    stages, bottleneck = _RESNET_DEPTHS[depth]
    layers = _conv_bn_shapes('conv', 3, 64, 7, data_format)
    cin, blk = 64, 0
    for i, n in enumerate(stages):
        f = 64 * 2 ** i
        cout = f * 4 if bottleneck else f
        for b in range(n):
            pre = f'blocks.{blk}.'
            if bottleneck:
                convs = [('conv0', cin, f, 1), ('conv1', f, f, 3),
                         ('conv2', f, cout, 1)]
            else:
                convs = [('conv0', cin, f, 3), ('conv1', f, f, 3)]
            if b == 0:
                convs.append(('short', cin, cout, 1))
            for name, ci, co, k in convs:
                layers.update(_conv_bn_shapes(pre + name, ci, co, k,
                                              data_format))
            cin, blk = cout, blk + 1
    layers.update({'out.weight': (cin, class_dim), 'out.bias': (class_dim,)})
    params = {n: s for n, s in layers.items() if not n.endswith('_buf')}
    buffers = {n: s for n, s in layers.items() if n.endswith('_buf')}
    return {**params, **buffers}


def _resnet_dims(named_numpy):
    """(depth, class_dim) of the ResNet these Paddle-layout arrays describe:
    blocks per stage from the highest block index and the block kind (a
    ``conv2`` means bottleneck), classes from ``out.bias``."""
    if 'out.bias' not in named_numpy:
        raise KeyError('missing parameter(s): out.bias')
    blocks = {int(n.split('.')[1]) for n in named_numpy
              if n.startswith('blocks.') and n.split('.')[1].isdigit()}
    bottleneck = 'blocks.0.conv2._conv.weight' in named_numpy
    n = max(blocks, default=-1) + 1
    for depth, (stages, bn) in _RESNET_DEPTHS.items():
        if bn == bottleneck and sum(stages) == n:
            return depth, int(np.shape(named_numpy['out.bias'])[0])
    raise KeyError(f'no ResNet depth has {n} '
                   f'{"bottleneck" if bottleneck else "basic"} blocks')


def resnet_state_dict_from_paddle(named_numpy, data_format):
    """Paddle-layout ``{name: ndarray}`` (the JAX ``ResNet``'s
    ``named_parameters()`` and ``named_buffers()`` as numpy) -> a torch
    state dict for the port's ``ResNet`` of the same ``data_format``: conv
    weights HWIO -> OIHW for NHWC (NCHW ones are OIHW already),
    ``out.weight`` (in, out) -> (out, in), BatchNorm parameters and buffers
    as they are; all f32. Raises on an unknown or missing name and on a
    shape that does not match the model the names describe."""
    depth, class_dim = _resnet_dims(named_numpy)
    shapes = resnet_expected_shapes(depth, class_dim, data_format)

    def relayout(name, arr):
        if data_format == 'NHWC' and arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        return arr

    return _to_state_dict(named_numpy, shapes, ('out',), relayout)


def resnet_init_params(depth, class_dim, data_format, seed):
    """Seeded Paddle-layout parameters and buffers for ``ResNet(depth,
    class_dim, data_format)`` built on numpy, as the reference initialises
    them (its distributions, not its bits): conv weights normal with std
    sqrt(2 / (kh * kw * C_in)), BatchNorm scale 1, bias 0, running mean 0
    and variance 1, ``out.weight`` uniform in +-1/sqrt(features),
    ``out.bias`` 0."""
    rng = np.random.default_rng(int(seed))
    out = {}
    for name, shape in resnet_expected_shapes(depth, class_dim,
                                              data_format).items():
        if name.endswith('_conv.weight'):
            if data_format == 'NHWC':
                kh, kw, cin, _ = shape
            else:
                _, cin, kh, kw = shape
            std = np.sqrt(2.0 / (kh * kw * cin))
            out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
        elif name == 'out.weight':
            stdv = 1.0 / np.sqrt(shape[0])
            out[name] = rng.uniform(-stdv, stdv, shape).astype(np.float32)
        elif name.endswith(('_bn.weight', '_variance_buf')):
            out[name] = np.ones(shape, np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def scope_from_paddle(named_numpy, scope=None, place=None, program=None):
    """Copy ``named_numpy`` ({name: array}, e.g. the JAX scope's
    persistables) into ``scope`` (the global scope if None) as tensors on
    ``place``'s device (the card if None). Each name the scope already
    holds, or that ``program`` declares, must keep that value's (or
    declaration's) shape and type; a mismatch raises and names the
    variable. Returns the names copied."""
    from .core.dtypes import convert_dtype, to_torch_dtype
    from .core.places import get_device
    from .core.scope import global_scope
    scope = scope if scope is not None else global_scope()
    dev = get_device(place)
    declared = ({v.name: v for v in program.list_vars()}
                if program is not None else {})
    for name, value in named_numpy.items():
        arr = np.asarray(value)
        want = None
        old = scope.find(name)
        if old is not None:
            want = (tuple(old.shape), convert_dtype(old.dtype))
        elif name in declared and declared[name].shape is not None:
            want = (declared[name].shape, declared[name].dtype)
        got = (tuple(arr.shape), convert_dtype(arr.dtype))
        if want is not None and want != got:
            raise ValueError(f'{name}: shape and dtype {got} do not match '
                             f'{want}')
        scope.set(name, torch.from_numpy(np.array(arr)).to(
            dev, to_torch_dtype(got[1])))
    return list(named_numpy)
