"""PaddleCV's static-graph ResNet image-classification recipe, as a user's
script writes it (PaddlePaddle/models, ``PaddleCV/image_classification``:
``models/resnet.py`` for the net, ``train.py`` and
``utility.py``/``optimizer.py`` for the loss, metrics and optimizer).

:func:`build` takes the ``fluid`` module it builds with and imports
neither package, so the same code builds in ``paddle_tpu_torch`` and in
the JAX package ``paddle_tpu``::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import static_resnet
    main, startup, test, v = static_resnet.build(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    loss, top1, top5 = exe.run(step, feed={'image': x, 'label': y},
                               fetch_list=[v['loss'], v['acc1'], v['acc5']])

The net: ``conv_bn_layer`` is ``conv2d(padding=(k - 1) // 2,
bias_attr=False)`` then ``batch_norm(act=)``; the stem a 7x7/2 conv of 64
filters with relu and a 3x3/2 max pool; bottleneck blocks (1x1, 3x3 with
the stride, 1x1 x4) over [3, 4, 6, 3] blocks of [64, 128, 256, 512]
filters for depth 50, a projection shortcut where channels or stride
change, the sum then relu (the recipe's ``elementwise_add(act='relu')``
as two layers, since neither package's generated ``elementwise_add``
takes ``act``); the head a global average pool and
``fc(class_dim)`` with ``Uniform(-1/sqrt(C), 1/sqrt(C))``, softmax,
``cross_entropy``, ``mean``, and ``accuracy`` at k = 1 and 5. The
optimizer is ``Momentum(piecewise_decay(boundaries at epochs 30, 60, 90,
values 0.1 x 0.1^i), 0.9, regularization=L2Decay(1e-4))``. Parameter
names are the recipe's (``res2a_branch2a_weights``, ``bn2a_branch2a_scale``,
...). ``blocks`` and ``width_div`` exist only to cut depth and width for
tests.

Mixed precision is the recipe's ``--use_fp16`` path, the optimizer wrapped
in ``fluid.contrib.mixed_precision.decorate(optimizer,
init_loss_scaling=SCALE_LOSS, use_dynamic_loss_scaling=True)``
(``build_model.py``, with ``ResNet50_fp16.sh``'s ``--scale_loss`` and
the recipe's default dynamic scaling; bf16 ignores the scale), with
``dtype`` ``amp`` ('float16' as the recipe, or 'bfloat16');
``recompute=True`` wraps it in ``fluid.optimizer.RecomputeOptimizer`` with
the 16 bottleneck blocks' outputs as checkpoints.

``optimizer='lars'`` trains with the large-batch LARS recipe instead
(``examples/train_resnet_lars.py``): a base rate of 0.1 x batch/256 (the
linear scaling rule, ``batch_size``), ``linear_lr_warmup`` from 0 over the
first tenth of ``lars_steps`` (90 epochs of ImageNet at that batch unless
given) into ``polynomial_decay(power=2)`` to 1e-4, and
``LarsMomentum(momentum=0.9, lars_coeff=0.001, lars_weight_decay=5e-4)``
with the biases and BatchNorm's scale and shift excluded from weight decay
(:func:`lars_excluded`), and no L2Decay regularizer. Sync-BN and the fleet
parts of that example are distributed training and are not here.
"""
from __future__ import annotations

import math

__all__ = ['BOUNDARIES', 'SCALE_LOSS', 'VALUES', 'build', 'lars_excluded',
           'lars_schedule']

DEPTHS = {50: [3, 4, 6, 3]}     # the recipe's other depths name blocks
                                # otherwise (res4b1, ...) and are not here
MOMENTUM, L2_DECAY = 0.9, 1e-4
# piecewise_decay's steps: epochs 30, 60 and 90 of ImageNet's 1281167
# training images at the recipe's batch of 256, rates 0.1 * 0.1**i
STEP_EACH_EPOCH = math.ceil(1281167 / 256)
BOUNDARIES = [STEP_EACH_EPOCH * e for e in (30, 60, 90)]
VALUES = [0.1 * (0.1 ** i) for i in range(len(BOUNDARIES) + 1)]
# the --use_fp16 recipe's initial loss scale (ResNet50_fp16.sh --scale_loss)
SCALE_LOSS = 128.0
# the LARS recipe (examples/train_resnet_lars.py)
LARS_EPOCHS, LARS_END_LR, LARS_POWER = 90, 1e-4, 2.0
LARS_MOMENTUM, LARS_COEFF, LARS_WEIGHT_DECAY = 0.9, 0.001, 5e-4


def lars_excluded(param):
    """Whether LARS leaves ``param`` out of weight decay: BatchNorm's
    scale and shift (``bn*``) and the fc bias (``*.b_0``)."""
    return param.name.startswith('bn') or param.name.endswith('.b_0')


def lars_schedule(batch_size, lars_steps=None):
    """``(base rate, warm-up steps, decay steps)`` of the LARS recipe at
    ``batch_size``."""
    steps = lars_steps or LARS_EPOCHS * math.ceil(1281167 / batch_size)
    return 0.1 * batch_size / 256.0, max(steps // 10, 2), max(steps, 10)


def _conv_bn_layer(fluid, x, num_filters, filter_size, stride=1, act=None,
                   name=None):
    conv = fluid.layers.conv2d(
        input=x, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, act=None,
        param_attr=fluid.ParamAttr(name=name + '_weights'), bias_attr=False,
        name=name + '.conv2d.output.1')
    bn_name = 'bn_' + name if name == 'conv1' else 'bn' + name[3:]
    return fluid.layers.batch_norm(
        input=conv, act=act, name=bn_name + '.output.1',
        param_attr=fluid.ParamAttr(name=bn_name + '_scale'),
        bias_attr=fluid.ParamAttr(bn_name + '_offset'),
        moving_mean_name=bn_name + '_mean',
        moving_variance_name=bn_name + '_variance')


def _bottleneck_block(fluid, x, num_filters, stride, name):
    conv0 = _conv_bn_layer(fluid, x, num_filters, 1, act='relu',
                           name=name + '_branch2a')
    conv1 = _conv_bn_layer(fluid, conv0, num_filters, 3, stride=stride,
                           act='relu', name=name + '_branch2b')
    conv2 = _conv_bn_layer(fluid, conv1, num_filters * 4, 1, act=None,
                           name=name + '_branch2c')
    if x.shape[1] != num_filters * 4 or stride != 1:
        short = _conv_bn_layer(fluid, x, num_filters * 4, 1, stride,
                               name=name + '_branch1')
    else:
        short = x
    return fluid.layers.relu(fluid.layers.elementwise_add(
        x=short, y=conv2, name=name + '.add.output.5'))


def _net(fluid, image, class_dim, blocks, width_div, block_outs):
    filters = [f // width_div for f in (64, 128, 256, 512)]
    conv = _conv_bn_layer(fluid, image, 64 // width_div, 7, stride=2,
                          act='relu', name='conv1')
    conv = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type='max')
    for block, count in enumerate(blocks):
        for i in range(count):
            conv = _bottleneck_block(
                fluid, conv, filters[block],
                stride=2 if i == 0 and block != 0 else 1,
                name='res' + str(block + 2) + chr(97 + i))
            block_outs.append(conv)
    pool = fluid.layers.pool2d(input=conv, pool_type='avg',
                               global_pooling=True)
    stdv = 1.0 / math.sqrt(pool.shape[1] * 1.0)
    return fluid.layers.fc(
        input=pool, size=class_dim,
        param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-stdv, stdv)))


def build(fluid, depth=50, class_dim=1000, image_shape=(3, 224, 224),
          blocks=None, width_div=1, amp=None, recompute=False,
          optimizer='momentum', batch_size=256, lars_steps=None):
    """The recipe's programs, built with ``fluid`` (either package).

    Returns ``(train program, startup program, test program, vars)``:
    the test program is the train program's ``clone(for_test=True)``
    taken before the optimizer (no backward, no step counter), given the
    train program's casts under ``amp``; ``vars`` holds ``image``,
    ``label``, ``logits``, ``prob`` (the softmax), ``loss``, ``acc1``,
    ``acc5``, ``lr`` (the schedule's rate, from ``BOUNDARIES`` and
    ``VALUES``, or LARS's warm-up and decay), ``optimizer`` (what
    ``minimize`` ran) and ``checkpoints`` (the bottleneck outputs)."""
    if optimizer not in ('momentum', 'lars'):
        raise ValueError(f'optimizer must be momentum or lars, got '
                         f'{optimizer!r}')
    blocks = list(blocks) if blocks is not None else DEPTHS[depth]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.data(name='image', shape=[None] + list(image_shape),
                           dtype='float32')
        label = fluid.data(name='label', shape=[None, 1], dtype='int64')
        block_outs = []
        logits = _net(fluid, image, class_dim, blocks, width_div,
                      block_outs)
        prob = fluid.layers.softmax(logits, use_cudnn=False)
        cost = fluid.layers.cross_entropy(input=prob, label=label)
        loss = fluid.layers.mean(cost)
        acc1 = fluid.layers.accuracy(input=prob, label=label, k=1)
        acc5 = fluid.layers.accuracy(input=prob, label=label, k=5)
        test = main.clone(for_test=True)
        if optimizer == 'lars':
            base_lr, warmup, decay = lars_schedule(batch_size, lars_steps)
            lr = fluid.layers.linear_lr_warmup(
                fluid.layers.polynomial_decay(
                    base_lr, decay_steps=decay,
                    end_learning_rate=LARS_END_LR, power=LARS_POWER),
                warmup_steps=warmup, start_lr=0.0, end_lr=base_lr)
            opt = fluid.optimizer.LarsMomentumOptimizer(
                lr, momentum=LARS_MOMENTUM, lars_coeff=LARS_COEFF,
                lars_weight_decay=LARS_WEIGHT_DECAY,
                exclude_from_weight_decay_fn=lars_excluded)
        else:
            lr = fluid.layers.piecewise_decay(boundaries=BOUNDARIES,
                                              values=VALUES)
            opt = fluid.optimizer.Momentum(
                learning_rate=lr, momentum=MOMENTUM,
                regularization=fluid.regularizer.L2Decay(L2_DECAY))
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(block_outs)
        if amp is not None:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=SCALE_LOSS,
                use_dynamic_loss_scaling=True, dtype=amp)
        opt.minimize(loss)
    if amp is not None:
        # evaluation under the train program's casts, as a clone taken
        # after decorate's minimize would have them
        test._amp_config = main._amp_config
    return main, startup, test, {
        'image': image, 'label': label, 'logits': logits, 'prob': prob,
        'loss': loss, 'acc1': acc1, 'acc5': acc5, 'lr': lr,
        'optimizer': opt, 'checkpoints': block_outs}
