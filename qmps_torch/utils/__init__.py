from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .logging import ConvergenceRecord, Timer  # noqa: F401
