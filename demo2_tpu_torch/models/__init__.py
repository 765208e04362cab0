from .demo import DeMo
from .factory import make_model
from .pife import PIFE
