"""python -m emrt_tpu_torch.train --config <yaml> [...]: see ``train/cli.py``."""
from .cli import main

if __name__ == "__main__":
    main()
