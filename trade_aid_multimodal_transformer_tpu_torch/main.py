"""trade-AId on PyTorch: the zero-flag training entry point.

    cd <directory with config.yaml + input_schemas.yaml>
    python -m trade_aid_multimodal_transformer_tpu_torch.main

The counterpart of the repository's ``main.py`` for the port: everything is
configured in the directory's files (or a programmatic ``config.py``), and
training runs on the card unless ``config.yaml`` says ``device: cpu``. With
``tpu_options.context_parallel: P`` it starts P rank processes, one card each
(``torchrun --nproc-per-node P -m trade_aid_multimodal_transformer_tpu_torch.main``
runs the same inside torchrun's group). Over several nodes, with
``tpu_options.multihost: true``, each node runs

    torchrun --nnodes N --node-rank i --nproc-per-node P --master-addr HOST
        --master-port PORT -m trade_aid_multimodal_transformer_tpu_torch.main

(one command line) and the plan spans the N P ranks (parallel/multihost.py).
"""

import sys
from pathlib import Path

from trade_aid_multimodal_transformer_tpu_torch.train.runner import run_training


def main() -> int:
    sys.path.insert(0, str(Path.cwd()))  # programmatic mode imports `config`
    run_training(caller_globals={})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
