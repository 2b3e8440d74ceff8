"""Host f64 numerics of the port, copied from tpusparse/numeric/ (held to
their originals by tests/test_torch_imports.py): the sparse triangular
solves (the extracted-factor solve path of ``SuperscanLU.solve_host``)
and the host engines with their one-call drivers (``cholsol``, ``lusol``,
``qrsol``: the reference's cs_* semantics in f64), which ``qrsol`` of
tpusparse_torch.device takes when the Q-less route's condition gate
refuses a problem."""

from .chol import Numeric, chol, updown
from .lu import lu
from .qr import house, happly, qr
from .trisolve import lsolve, ltsolve, usolve, utsolve, spsolve
from .solvers import cholsol, lusol, qrsol

__all__ = [
    "Numeric", "chol", "updown", "lu", "house", "happly", "qr",
    "lsolve", "ltsolve", "usolve", "utsolve", "spsolve",
    "cholsol", "lusol", "qrsol",
]
