"""A frozen copy of the plain torch code of the renderer's frame: the
scene and camera, the TLAS and per-mesh LBVH, the plain wavefront
traversal, the three ray waves and their shading, the plain spatial
passes, the TAA and the tone map.  It holds no kernel and imports nothing
outside this package and torch / numpy; ``reference/frame.py`` drives it.
Copied so that a later change to the measured program cannot move the
yardstick it is judged by."""
