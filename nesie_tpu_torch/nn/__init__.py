from .detector import VoteNetNesie
from .nesie_head import NesieHead
from .pointnet2 import PointFPModule, PointNet2SASSG, PointSAModule

__all__ = ["NesieHead", "PointFPModule", "PointNet2SASSG", "PointSAModule",
           "VoteNetNesie"]
