from .converters import convert_flax_variables
from .metrics import R1mAPEvaluator, cmc_map, euclidean_distance
