"""L7: PovRay-subset SDL parser and the reference CLI's scene conventions."""

from raysnail_tpu_torch.sdl.driver import build_scene
from raysnail_tpu_torch.sdl.parser import SceneData, SdlParser

__all__ = ["SdlParser", "SceneData", "build_scene"]
