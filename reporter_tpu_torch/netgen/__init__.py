"""Road-network sources: the RoadNetwork type and the synthetic generator."""

from reporter_tpu_torch.netgen.network import RoadNetwork, Way
from reporter_tpu_torch.netgen.synthetic import generate_city

__all__ = ["RoadNetwork", "Way", "generate_city"]
