"""Geospatial engine: Hierarchical Triangular Mesh (HTM) trixel covers,
spherical geometry, EWKT parsing.

Reference parity target: src/geospatial/ (~8.5k LoC: htm.*, cartesian.*,
geometry.*, ewkt.*). The TPU build quantises trixel ids to HTM level 13 so
ranges fit int32 device columns; exact range-intersection filtering runs
vectorised on-device (xapiand_tpu.ops.values.geo_intersects).
"""

from xapiand_tpu_torch.geo import htm  # noqa: F401
