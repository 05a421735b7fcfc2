"""The JAX package's examples (``examples/``) on the port, one module each.

Every example has ``main(device=None)``: the card unless ``device`` says
otherwise (``config.resolve_device``).  Run one with

    python -m qmps_torch.examples.<name>          # on the card
    python -m qmps_torch.examples.<name> --cpu    # on the CPU, float64

Random numbers come from seeded ``torch.Generator``s, so the numbers match
the JAX examples' in kind, not digit for digit.
"""
import sys


def cli_device():
    """The device a command line asks for: "cpu" with ``--cpu``, else None
    (the card)."""
    return "cpu" if "--cpu" in sys.argv[1:] else None
