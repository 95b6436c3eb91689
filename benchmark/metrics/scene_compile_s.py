"""Seconds of the host clock around the port's scene compile
(`SceneBuilder.compile`: the host BVH build, the leaf packing and the
upload; `scenes.compile_scene`), read in set-up. Moves setup_s."""


def read(run):
    return run.scene_compile_s
