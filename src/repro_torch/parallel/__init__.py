"""Sharding rules and the parallel context: specs as DeviceMesh/DTensor
placements (ROADMAP.md queue 1 item 9a).  The model itself runs sharded
over a multi-rank mesh only from item 9b on."""
