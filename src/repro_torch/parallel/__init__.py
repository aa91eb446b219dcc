"""Sharding rules, the parallel context, the shard_map bodies' collectives
and the pipeline: specs as DeviceMesh/DTensor placements (ROADMAP.md
queue 1 items 9a and 9b)."""
