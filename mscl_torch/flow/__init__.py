from .pwclite import PWCLite, build_pwclite
from .raft import (RAFT, build_raft, coords_grid, load_raft_pth,
                   upsample_flow_convex)

__all__ = ['PWCLite', 'RAFT', 'build_pwclite', 'build_raft', 'coords_grid',
           'load_raft_pth', 'upsample_flow_convex']
