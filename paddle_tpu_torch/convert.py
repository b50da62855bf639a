"""Weights between the JAX package's layout and the port's.

The JAX model's ``named_parameters()`` names and the port's ``state_dict()``
names are the same (``blocks.0.attn.q.weight``,
``bert.encoder.0.attn.q.weight``, ``enc_0.attn.q.weight``, ...), and so are
the layouts of Linear weights ((in, out), Paddle's), embeddings (V, H),
LayerNorm scale and bias and BERT's ``heads.decoder_bias``: those load as
they are, checked by name and shape and made f32.

- ``TransformerLM``: :func:`expected_shapes`, :func:`state_dict_from_paddle`,
  :func:`init_params`.
- ``BertForPretraining``: :func:`bert_expected_shapes`,
  :func:`bert_state_dict_from_paddle`, :func:`bert_init_params`. The MLM
  decoder is tied to ``bert.word_emb.weight``, so one tensor is loaded for
  both.
- ``ErnieForSequenceClassification``: :func:`ernie_expected_shapes`,
  :func:`ernie_state_dict_from_paddle`, :func:`ernie_init_params`: BERT's
  backbone under ``backbone.`` and the ``classifier`` Linear.
- ``ResNet``: :func:`resnet_expected_shapes`,
  :func:`resnet_state_dict_from_paddle`, :func:`resnet_init_params`. The
  names cover the parameters and BatchNorm's running-statistics buffers.
  The port's conv weights are OIHW whatever the data format: an NHWC
  checkpoint's HWIO weights are transposed, an NCHW one's are OIHW
  already; BatchNorm's parameters and buffers keep their layout. These
  are torch state dicts, for ``load_state_dict``; the model's own
  ``set_dict`` takes the reference's arrays as they are (dygraph/nn.py
  ``Conv2D``).
- The NMT ``Transformer``: :func:`transformer_expected_shapes`,
  :func:`transformer_state_dict_from_paddle`,
  :func:`transformer_init_params`. With ``weight_sharing`` the one table
  appears under both ``src_emb.weight`` and ``trg_emb.weight``, as in the
  JAX model's ``state_dict()``.
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
           'bert_init_params', 'ernie_expected_shapes',
           'ernie_state_dict_from_paddle', 'ernie_init_params',
           'resnet_expected_shapes',
           'resnet_state_dict_from_paddle', 'resnet_init_params',
           'transformer_expected_shapes',
           'transformer_state_dict_from_paddle', 'transformer_init_params',
           'scope_from_paddle']


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
    ``TransformerLM``, all f32. Raises on an unknown or missing name and on
    a shape that does not match the model the embeddings and block 0
    describe."""
    return _to_state_dict(named_numpy, _infer_shapes(named_numpy))


def _to_state_dict(named_numpy, shapes, relayout=None):
    """Check names and Paddle-layout shapes, then apply
    ``relayout(name, arr)`` (if given) to every array."""
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
    ``BertForPretraining``, all f32.
    Raises on an unknown or missing name and on a shape that does not match
    the model the embeddings and block 0 describe."""
    from .models.bert import BertConfig
    if 'bert.type_emb.weight' not in named_numpy:
        raise KeyError('missing parameter(s): bert.type_emb.weight')
    cfg = BertConfig(
        **_infer_dims(named_numpy, 'bert.'),
        type_vocab_size=np.shape(named_numpy['bert.type_emb.weight'])[0])
    return _to_state_dict(named_numpy, bert_expected_shapes(cfg))


def bert_init_params(cfg, seed):
    """Seeded Paddle-layout parameters for ``BertForPretraining(cfg)``, as
    :func:`init_params` makes them: embeddings and Linear weights truncated
    normal with std ``cfg.initializer_range``, Linear biases and
    ``heads.decoder_bias`` 0, LayerNorm scale 1 and bias 0."""
    return _init(bert_expected_shapes(cfg), cfg.initializer_range, seed)


def ernie_expected_shapes(cfg, num_labels=2):
    """{name: shape} of an ``ErnieForSequenceClassification(cfg,
    num_labels)``'s parameters in Paddle layout, in the JAX model's
    ``named_parameters()`` order."""
    shapes = {'backbone.' + n[len('bert.'):]: shp
              for n, shp in bert_expected_shapes(cfg).items()
              if n.startswith('bert.')}
    shapes.update({'classifier.weight': (cfg.hidden_size, num_labels),
                   'classifier.bias': (num_labels,)})
    return shapes


def ernie_state_dict_from_paddle(named_numpy):
    """Paddle-layout ``{name: ndarray}`` (the JAX
    ``ErnieForSequenceClassification``'s ``named_parameters()`` as numpy)
    -> a state dict for the port's, all f32 (``load_state_dict`` or
    ``set_dict``). Raises on an unknown or missing name and on a shape
    that does not match the model the embeddings, block 0 and the
    classifier describe."""
    from .models.ernie import ErnieConfig
    for name in ('backbone.type_emb.weight', 'classifier.bias'):
        if name not in named_numpy:
            raise KeyError(f'missing parameter(s): {name}')
    cfg = ErnieConfig(
        **_infer_dims(named_numpy, 'backbone.'),
        type_vocab_size=np.shape(named_numpy['backbone.type_emb.weight'])[0])
    labels = np.shape(named_numpy['classifier.bias'])[0]
    return _to_state_dict(named_numpy, ernie_expected_shapes(cfg, labels))


def ernie_init_params(cfg, seed, num_labels=2):
    """Seeded Paddle-layout parameters for
    ``ErnieForSequenceClassification(cfg, num_labels)``, drawn as
    :func:`bert_init_params` draws BERT's."""
    return _init(ernie_expected_shapes(cfg, num_labels),
                 cfg.initializer_range, seed)


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
    weights HWIO -> OIHW for NHWC (NCHW ones are OIHW already), everything
    else as it is; all f32. Raises on an unknown or missing name and on a
    shape that does not match the model the names describe."""
    depth, class_dim = _resnet_dims(named_numpy)
    shapes = resnet_expected_shapes(depth, class_dim, data_format)

    def relayout(name, arr):
        if data_format == 'NHWC' and arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        return arr

    return _to_state_dict(named_numpy, shapes, relayout)


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


def transformer_expected_shapes(cfg):
    """{name: shape} of a ``Transformer(cfg)``'s state dict (the NMT model
    of models/transformer.py), in the JAX model's order: the embeddings,
    then ``enc_i`` and ``dec_i`` in turn, then ``proj``."""
    d, f = cfg.d_model, cfg.d_inner

    def linear(prefix, i, o):
        return {f'{prefix}.weight': (i, o), f'{prefix}.bias': (o,)}

    def norm(prefix):
        return {f'{prefix}.weight': (d,), f'{prefix}.bias': (d,)}

    def attn(prefix):
        out = {}
        for sub in ('q', 'k', 'v', 'out'):
            out.update(linear(f'{prefix}.{sub}', d, d))
        return out

    def ffn(prefix):
        return {**linear(f'{prefix}.fc1', d, f),
                **linear(f'{prefix}.fc2', f, d)}

    shapes = {'src_emb.weight': (cfg.src_vocab_size, d),
              'trg_emb.weight': (cfg.trg_vocab_size, d)}
    for i in range(cfg.n_layer):
        e, t = f'enc_{i}', f'dec_{i}'
        shapes.update({**attn(f'{e}.attn'), **norm(f'{e}.ln1'),
                       **ffn(f'{e}.ffn'), **norm(f'{e}.ln2')})
        shapes.update({**attn(f'{t}.self_attn'), **norm(f'{t}.ln1'),
                       **attn(f'{t}.cross_attn'), **norm(f'{t}.ln2'),
                       **ffn(f'{t}.ffn'), **norm(f'{t}.ln3')})
    shapes.update(linear('proj', d, cfg.trg_vocab_size))
    return shapes


def transformer_state_dict_from_paddle(named_numpy):
    """Paddle-layout ``{name: ndarray}`` (the JAX ``Transformer``'s
    ``state_dict()`` as numpy) -> a torch state dict for the port's
    ``Transformer``, all f32. The widths, vocabularies and depth are read
    from the embeddings, ``enc_0``'s FFN and the highest layer index.
    Raises on an unknown or missing name and on a shape that does not
    match."""
    from .models.transformer import TransformerConfig
    for name in ('src_emb.weight', 'trg_emb.weight', 'enc_0.ffn.fc1.weight'):
        if name not in named_numpy:
            raise KeyError(f'missing parameter(s): {name}')
    vs, d = np.shape(named_numpy['src_emb.weight'])
    layers = 1 + max(int(n.split('.')[0][4:]) for n in named_numpy
                     if n.startswith('enc_'))
    cfg = TransformerConfig(
        src_vocab_size=vs,
        trg_vocab_size=np.shape(named_numpy['trg_emb.weight'])[0],
        d_model=d, n_head=1, n_layer=layers,
        d_inner=np.shape(named_numpy['enc_0.ffn.fc1.weight'])[1])
    return _to_state_dict(named_numpy, transformer_expected_shapes(cfg))


def transformer_init_params(cfg, seed):
    """Seeded Paddle-layout weights for ``Transformer(cfg)`` built on
    numpy, from the reference's distributions (not its bits): embeddings
    and Linear weights Normal(0, d_model**-0.5) in f32, biases 0,
    LayerNorm scale 1 and shift 0. With ``cfg.weight_sharing`` (and equal
    vocabularies) ``trg_emb.weight`` is the same array as
    ``src_emb.weight``."""
    rng = np.random.default_rng(int(seed))
    std = np.float32(cfg.d_model ** -0.5)
    shared = cfg.weight_sharing and cfg.src_vocab_size == cfg.trg_vocab_size
    out = {}
    for name, shape in transformer_expected_shapes(cfg).items():
        if shared and name == 'trg_emb.weight':
            out[name] = out['src_emb.weight']
        elif '.ln' in name:
            fill = 1.0 if name.endswith('weight') else 0.0
            out[name] = np.full(shape, fill, np.float32)
        elif name.endswith('bias'):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, np.float32) * std
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
