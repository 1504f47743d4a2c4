"""ADE20K semantic-class names (ids 0..149) + the unlabeled sentinel.

Counterpart of ``gsplat_tpu.assets.ade20k``, a copy of its names. The
standard ADE20K-150 class list as used by the HuggingFace SegFormer /
Mask2Former ADE checkpoints; the reference viewer ships the same mapping as
a JSON asset and shows the selected label's class name in its selection-info
panel (Web_Viewer_Gaussians_Selection/ade20k-id2label.json,
gaussians_selection.js:1875-1881, 981-1004; index.html:328-331).

``id2label()`` reproduces the reference asset's exact mapping, including the
``-1 -> "unlabeled"`` sentinel for never-visible gaussians
(deep_learning_segmentation.py:297-308) and the trailing space of
``'bed '``, which the reference asset has.
"""

from __future__ import annotations

from typing import Dict

ADE20K_CLASSES = (
    'wall',
    'building',
    'sky',
    'floor',
    'tree',
    'ceiling',
    'road',
    'bed ',
    'windowpane',
    'grass',
    'cabinet',
    'sidewalk',
    'person',
    'earth',
    'door',
    'table',
    'mountain',
    'plant',
    'curtain',
    'chair',
    'car',
    'water',
    'painting',
    'sofa',
    'shelf',
    'house',
    'sea',
    'mirror',
    'rug',
    'field',
    'armchair',
    'seat',
    'fence',
    'desk',
    'rock',
    'wardrobe',
    'lamp',
    'bathtub',
    'railing',
    'cushion',
    'base',
    'box',
    'column',
    'signboard',
    'chest of drawers',
    'counter',
    'sand',
    'sink',
    'skyscraper',
    'fireplace',
    'refrigerator',
    'grandstand',
    'path',
    'stairs',
    'runway',
    'case',
    'pool table',
    'pillow',
    'screen door',
    'stairway',
    'river',
    'bridge',
    'bookcase',
    'blind',
    'coffee table',
    'toilet',
    'flower',
    'book',
    'hill',
    'bench',
    'countertop',
    'stove',
    'palm',
    'kitchen island',
    'computer',
    'swivel chair',
    'boat',
    'bar',
    'arcade machine',
    'hovel',
    'bus',
    'towel',
    'light',
    'truck',
    'tower',
    'chandelier',
    'awning',
    'streetlight',
    'booth',
    'television receiver',
    'airplane',
    'dirt track',
    'apparel',
    'pole',
    'land',
    'bannister',
    'escalator',
    'ottoman',
    'bottle',
    'buffet',
    'poster',
    'stage',
    'van',
    'ship',
    'fountain',
    'conveyer belt',
    'canopy',
    'washer',
    'plaything',
    'swimming pool',
    'stool',
    'barrel',
    'basket',
    'waterfall',
    'tent',
    'bag',
    'minibike',
    'cradle',
    'oven',
    'ball',
    'food',
    'step',
    'tank',
    'trade name',
    'microwave',
    'pot',
    'animal',
    'bicycle',
    'lake',
    'dishwasher',
    'screen',
    'blanket',
    'sculpture',
    'hood',
    'sconce',
    'vase',
    'traffic light',
    'tray',
    'ashcan',
    'fan',
    'pier',
    'crt screen',
    'plate',
    'monitor',
    'bulletin board',
    'shower',
    'radiator',
    'glass',
    'clock',
    'flag',
)

UNLABELED_NAME = "unlabeled"


def id2label() -> Dict[int, str]:
    """{-1: "unlabeled", 0: "wall", ..., 149: "flag"} (151 entries)."""
    m = {-1: UNLABELED_NAME}
    m.update(dict(enumerate(ADE20K_CLASSES)))
    return m


def label_name(label: int) -> str:
    """Class name for a label id; ids outside ADE20K echo the number."""
    if label == -1:
        return UNLABELED_NAME
    if 0 <= label < len(ADE20K_CLASSES):
        return ADE20K_CLASSES[label]
    return str(label)
