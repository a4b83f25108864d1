"""Entry point of ``python -m repro_torch.tune``."""
from repro_torch.tune.cli import main

if __name__ == "__main__":
    main()
