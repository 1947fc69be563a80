from .raft import (RAFT, build_raft, coords_grid, load_raft_pth,
                   upsample_flow_convex)

__all__ = ['RAFT', 'build_raft', 'coords_grid', 'load_raft_pth',
           'upsample_flow_convex']
