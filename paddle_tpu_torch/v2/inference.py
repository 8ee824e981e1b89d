"""v2 inference (reference python/paddle/v2/inference.py paddle.infer)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import fluid
from .parameters import _check_device, _v2_device


def infer(output_layer, parameters, input, feeding: Optional[Dict] = None,
          field: str = "value", device=None):
    """Run the pruned inference slice of the topology on `input` (a list of
    samples) and return the stacked outputs. It runs on the v2 device
    (``device=``, else ``init``'s, else the card), which must be where
    ``parameters`` live."""
    device = _v2_device(device)
    _check_device(parameters, device)
    main = parameters.main_program
    infer_prog = fluid.io.get_inference_program([output_layer],
                                                main_program=main)
    block = infer_prog.global_block()
    needed = set()
    for op in block.ops:
        needed.update(n for n in op.desc.input_names() if n)
    from .trainer import _data_var_names

    feed_names = [n for n in _data_var_names(main.global_block())
                  if n in needed]
    if feeding is not None:
        order = sorted(feeding.items(), key=lambda kv: kv[1])
        feed_names = [n for n, _ in order if n in needed] or feed_names
    feeder = fluid.DataFeeder(
        place=None, feed_list=[main.global_block().var(n) for n in feed_names]
    )
    exe = fluid.Executor(device)
    with fluid.scope_guard(parameters.scope):
        (out,) = exe.run(infer_prog, feed=feeder.feed(input),
                         fetch_list=[output_layer])
    return np.asarray(out)
