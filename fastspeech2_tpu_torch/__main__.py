"""``python -m fastspeech2_tpu_torch {preprocess,stats,train,evaluate,average,gta,
convert,synth,serve} ...``: see ``cli.py``."""

import logging
import sys

from fastspeech2_tpu_torch.cli import main

if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main(sys.argv[1:])
