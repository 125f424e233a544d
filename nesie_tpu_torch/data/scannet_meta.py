"""ScanNet and SUN RGB-D detection metadata (factual constants; reference
configs/Nesie/nesie-votenet-scannet-train-010.py:155-174,
mmdet3d/datasets/scannet_dataset.py and sunrgbd_dataset.py). A copy of
``nesie_tpu/data/scannet_meta.py`` plus the SUN RGB-D class names of
``nesie_tpu/data/sunrgbd_prep.py``."""

CLASS_NAMES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtrain", "toilet", "sink", "bathtub", "garbagebin",
)
NUM_CLASSES = len(CLASS_NAMES)

# nyu40 ids of the 18 detection classes, in class order
VALID_CAT_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
MAX_CAT_ID = 40

CAT_ID_TO_CLASS = {cid: i for i, cid in enumerate(VALID_CAT_IDS)}

NUM_POINTS = 40000
MAX_GT = 64

SUNRGBD_CLASS_NAMES = (
    "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
    "night_stand", "bookshelf", "bathtub",
)
