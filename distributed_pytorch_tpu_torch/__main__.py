"""Trainer CLI: `python -m distributed_pytorch_tpu_torch --flags...`

Counterpart of `python -m distributed_pytorch_tpu` (__main__.py:23-67):
one flag per field of `LLMConfig` and `TrainConfig`, `--preset` to seed
the model defaults with a size preset (explicit flags still override),
`--total_batch_size_str "2**14"`, and `--knobs` to print the env-knob
registry. Trains on the CUDA card; `--platform cpu` runs on the CPU, and
with no card and no such request it exits with an error. For example:

    python -m distributed_pytorch_tpu_torch --preset gpt2_124m \\
        --attn_impl pallas --dataset synthetic --data_dir /tmp/data \\
        --batch_size 8 --total_batch_size_str "2**14" --max_iters 20

A data-parallel recipe runs one process per card under torchrun, with
`--batch_size` per process:

    python -m torch.distributed.run --nproc_per_node 8 \\
        -m distributed_pytorch_tpu_torch --parallelism fsdp ...

and a tensor-parallel one cuts the model over `--tp_size` adjacent
processes, the rest of the world on 'data' (here 2 x 4):

    python -m torch.distributed.run --nproc_per_node 8 \\
        -m distributed_pytorch_tpu_torch --parallelism fsdp_tp \\
        --tp_size 4 ...

and a sequence-parallel one cuts each row's positions over `--sp_size`
adjacent processes (ring, zig-zag or Ulysses attention, `--attn_impl`),
under `sp` or dp / zero1 / zero2 / fsdp (here 4 x 2):

    python -m torch.distributed.run --nproc_per_node 8 \\
        -m distributed_pytorch_tpu_torch --parallelism fsdp --sp_size 2 ...

and an expert-parallel one cuts an MoE's experts over `--ep_size`
adjacent processes, under `ep` (dp) or fsdp (here 4 x 2):

    python -m torch.distributed.run --nproc_per_node 8 \\
        -m distributed_pytorch_tpu_torch --moe ... --parallelism fsdp \\
        --ep_size 2 ...
"""

from distributed_pytorch_tpu_torch.config import (PRESETS, build_parser,
                                                  configs_from_args,
                                                  knobs_table)


def parse_train_argv(argv):
    """(model_cfg, train_cfg) from a train command line; a `--preset` is
    applied by re-parsing against its defaults so explicit flags win."""
    args = build_parser().parse_args(argv)
    model_defaults = None
    if args.preset:
        model_defaults = PRESETS[args.preset]()
        args = build_parser(model_defaults=model_defaults).parse_args(argv)
    return configs_from_args(args, model_defaults=model_defaults)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.knobs:
        print(knobs_table())
        return
    model_cfg, train_cfg = parse_train_argv(argv)
    from distributed_pytorch_tpu_torch.train.loop import train
    train(model_cfg, train_cfg)


if __name__ == "__main__":
    main()
