"""Road-network sources: the RoadNetwork type, the synthetic grid and
organic generators, and the OSM XML and PBF parsers."""

from reporter_tpu_torch.netgen.network import RoadNetwork, TurnRestriction, Way
from reporter_tpu_torch.netgen.osm_xml import parse_osm_xml
from reporter_tpu_torch.netgen.pbf import parse_osm_pbf
from reporter_tpu_torch.netgen.synthetic import generate_city

__all__ = ["RoadNetwork", "TurnRestriction", "Way", "generate_city",
           "parse_osm_pbf", "parse_osm_xml"]
