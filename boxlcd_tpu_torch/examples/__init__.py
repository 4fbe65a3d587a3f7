"""The port's examples (the counterpart of the repo's `examples/`): the
smallest end-to-end path through the simulator, each a module with a
`main(argv=None)`:

    python -m boxlcd_tpu_torch.examples.basic [--device=cpu]
    python -m boxlcd_tpu_torch.examples.less_basic [--headless=1]
    python -m boxlcd_tpu_torch.examples.collect --num_eps=1000 \
        --out=/tmp/ex_rollouts.npz
    python -m boxlcd_tpu_torch.examples.train --data=/tmp/ex_rollouts.npz

Each runs on the card unless --device=cpu.
"""
