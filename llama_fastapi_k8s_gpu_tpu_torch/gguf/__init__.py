from .constants import GGMLType, GGUFValueType  # noqa: F401
from .reader import GGUFFile, GGUFTensor  # noqa: F401
from .writer import GGUFWriter  # noqa: F401
from . import quants  # noqa: F401
