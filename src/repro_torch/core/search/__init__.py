from .space import (
    Categorical, Domain, Function, GridSearch, LogUniform, Normal, QRandInt,
    RandInt, Uniform, choice, grid_search, loguniform, normal, qrandint,
    randint, sample_from, sample_space, space_signature,
)
from .variants import count_grid_variants, format_variant_tag, generate_variants
from .basic import GridSearcher, RandomSearcher, Searcher
from .tpe import TPESearcher
from .gp import GPSearcher
