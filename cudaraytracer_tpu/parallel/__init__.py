from .tiling import ShardedRenderer, make_mesh, render_sharded

__all__ = ["ShardedRenderer", "make_mesh", "render_sharded"]
