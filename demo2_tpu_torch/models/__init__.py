from .demo import DeMo, DeMoLegacy, DeMoParallel
from .factory import make_model
from .pife import PIFE
