"""Command-line tools around the port: `bvh_viz`, the BVH inspector."""
