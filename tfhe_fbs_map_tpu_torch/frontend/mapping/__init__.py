from .basic import BasicMapper
from .heuristic import HeuristicMapper, map_best

__all__ = ["BasicMapper", "HeuristicMapper", "map_best"]
