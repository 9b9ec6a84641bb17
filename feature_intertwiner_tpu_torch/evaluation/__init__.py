"""COCO evaluation of the port: RLE masks, the COCO index and COCOeval."""

from .coco import COCO  # noqa: F401
from .cocoeval import COCOeval  # noqa: F401
