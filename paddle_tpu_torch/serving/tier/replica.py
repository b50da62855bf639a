"""Decode replica process: a seeded ``TransformerLM`` behind a
``DecodeScheduler`` + ``ServingServer`` (counterpart of
paddle_tpu/serving/tier/replica.py), launched as

    python -m paddle_tpu_torch.serving.tier.replica --port 0 --seed 1234

It runs on the CUDA card unless ``--device cpu`` is given. ``--config
default`` (the default) serves ``CausalLMConfig()`` at its full width;
``--config tiny`` the test-scale model. Weights come from
``convert.init_params(cfg, seed)``, so every process started with one seed
serves the same parameters.

``--spec-decode 1`` (with ``--spec-k`` and ``--drafter``) turns on
speculative decoding; ``PADDLE_TPU_KV_DTYPE=bf16|int8`` stores the KV pool
quantized; ``--prefix-cache 1`` (or ``PADDLE_TPU_PREFIX_CACHE=1``) serves
shared prompt prefixes from the pool; ``--disagg 1`` (or
``PADDLE_TPU_DISAGG=1``) prefills on a second engine beside the decode
engine and hands the blocks over.

On start the replica warms the engine (every prefill rung, one decode step
and, with speculative decoding, one verify step, which also builds the CUDA
kernels), prints ONE JSON line to stdout,
``{"ready": true, "port": N, "pid": P, "replica_id": ..., "device": ...}``,
and serves until killed.
"""
from __future__ import annotations

import json
import os
import sys

__all__ = ['build_lm', 'build_replica_stack', 'main', 'DEFAULT_SEED',
           'ENGINE_DEFAULTS']

DEFAULT_SEED = 1234

# the engine geometry of a full-width replica: 8 slots, prompts up to 256
# tokens (ladder 1..256), up to 128 new tokens, so padded_context is 384
# (24 blocks of 16) inside a 256-block pool
ENGINE_DEFAULTS = {'slots': 8, 'block_size': 16, 'max_blocks': 256,
                   'max_prompt_len': 256, 'max_new_tokens_cap': 128}


def build_lm(config='default', seed=DEFAULT_SEED, device=None):
    """``TransformerLM`` at ``config`` ('default' | 'tiny') on ``device``,
    with parameters from ``init_params(cfg, seed)``, in eval mode."""
    from ...convert import init_params, state_dict_from_paddle
    from ...models.causal_lm import CausalLMConfig, TransformerLM
    configs = {'default': CausalLMConfig, 'tiny': CausalLMConfig.tiny}
    if config not in configs:
        raise ValueError(f'config must be one of {sorted(configs)}, got '
                         f'{config!r}')
    cfg = configs[config]()
    model = TransformerLM(cfg, device=device)
    model.load_state_dict(state_dict_from_paddle(init_params(cfg, seed)))
    model.eval()
    return model


def build_replica_stack(model, queue_depth=128, replica_id=None,
                        drafter=None, prefix_cache=None, disagg=None,
                        **engine_kw):
    """(engine, scheduler, prefill worker or None): the replica's serving
    stack minus the HTTP listener, as the reference's. ``engine_kw``
    overrides :data:`ENGINE_DEFAULTS` (and takes ``spec_decode``,
    ``spec_k`` and ``kv_dtype``); ``drafter`` goes to the scheduler.
    ``prefix_cache`` (default ``PADDLE_TPU_PREFIX_CACHE``) goes to the
    decode engine. ``disagg`` (default ``PADDLE_TPU_DISAGG``) builds a
    prefill-role engine on the same model (its own pool, no prefix cache,
    the decode engine's geometry and storage) and a
    :class:`~.disagg.LocalPrefillWorker` over it, which the caller closes
    after the scheduler. The two engines share no model lock (the port
    needs none, see ``DecodeEngine``)."""
    from ..decode import DecodeEngine, DecodeScheduler
    from .knobs import ENV_DISAGG, parse_flag_env
    if disagg is None:
        disagg = parse_flag_env(ENV_DISAGG, False)
    kw = {**ENGINE_DEFAULTS, **engine_kw}
    engine = DecodeEngine(model, prefix_cache=prefix_cache, **kw)
    worker = None
    if disagg:
        from .disagg import LocalPrefillWorker, PrefillReplica
        geometry = {k: v for k, v in kw.items()
                    if k not in ('slots', 'spec_decode', 'spec_k')}
        geometry['kv_dtype'] = engine.pool.kv_dtype
        prefill_engine = DecodeEngine(model, slots=1, prefix_cache=False,
                                      **geometry)
        worker = LocalPrefillWorker(PrefillReplica(prefill_engine))
    scheduler = DecodeScheduler(engine, queue_depth=queue_depth,
                                replica_id=replica_id, drafter=drafter,
                                disagg=worker)
    return engine, scheduler, worker


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description='paddle_tpu_torch decode replica (seeded causal LM)')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=0)
    ap.add_argument('--seed', type=int, default=DEFAULT_SEED)
    ap.add_argument('--config', choices=('default', 'tiny'),
                    default='default')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA card; "cpu" must '
                         'be asked for)')
    ap.add_argument('--slots', type=int, default=ENGINE_DEFAULTS['slots'])
    ap.add_argument('--block-size', type=int,
                    default=ENGINE_DEFAULTS['block_size'])
    ap.add_argument('--max-blocks', type=int,
                    default=ENGINE_DEFAULTS['max_blocks'])
    ap.add_argument('--max-prompt-len', type=int,
                    default=ENGINE_DEFAULTS['max_prompt_len'])
    ap.add_argument('--max-new-tokens-cap', type=int,
                    default=ENGINE_DEFAULTS['max_new_tokens_cap'])
    ap.add_argument('--replica-id', default=None)
    ap.add_argument('--spec-decode', type=int, choices=(0, 1), default=None,
                    help='speculative decoding on/off (default: the '
                         'PADDLE_TPU_SPEC_DECODE knob, off; an env 0 always '
                         'wins)')
    ap.add_argument('--spec-k', type=int, default=None,
                    help='speculative verify window (default: '
                         'PADDLE_TPU_SPEC_K, 4)')
    ap.add_argument('--drafter', default=None,
                    choices=('ngram', 'draft_model', 'off'),
                    help='draft proposer (default: PADDLE_TPU_SPEC_DRAFTER, '
                         'ngram)')
    ap.add_argument('--prefix-cache', type=int, choices=(0, 1), default=None,
                    help='the radix prefix cache on/off (default: '
                         'PADDLE_TPU_PREFIX_CACHE, off)')
    ap.add_argument('--disagg', type=int, choices=(0, 1), default=None,
                    help='disaggregated prefill on/off (default: '
                         'PADDLE_TPU_DISAGG, off)')
    args = ap.parse_args(argv)

    from ..server import ServingServer
    model = build_lm(args.config, args.seed, args.device)
    engine, scheduler, worker = build_replica_stack(
        model, replica_id=args.replica_id, slots=args.slots,
        block_size=args.block_size, max_blocks=args.max_blocks,
        max_prompt_len=args.max_prompt_len,
        max_new_tokens_cap=args.max_new_tokens_cap,
        spec_decode=(None if args.spec_decode is None
                     else bool(args.spec_decode)),
        spec_k=args.spec_k, drafter=args.drafter,
        prefix_cache=(None if args.prefix_cache is None
                      else bool(args.prefix_cache)),
        disagg=None if args.disagg is None else bool(args.disagg))
    srv = ServingServer(None, host=args.host, port=args.port,
                        generator=scheduler, warmup=True)
    # the launcher parses this single stdout line for the port and pid
    sys.stdout.write(json.dumps({'ready': True, 'port': srv.port,
                                 'pid': os.getpid(),
                                 'replica_id': scheduler.replica_id,
                                 'device': str(engine.device),
                                 'spec_decode': engine.spec_enabled,
                                 'spec_k': engine.spec_k,
                                 'kv_dtype': engine.pool.kv_dtype,
                                 'prefix_cache':
                                     engine.prefix_cache is not None,
                                 'disagg': worker is not None}) + '\n')
    sys.stdout.flush()
    try:
        srv.serve_forever()
    finally:
        if worker is not None:
            worker.close()


if __name__ == '__main__':
    main()
