"""The benchmark's plain reference for the physics worlds: a frozen copy of
the port's plain torch physics (engine/{geom,collision,physics,spec}.py),
world definitions, plain PIL-exact raster and the functional env core
(reset and observation), importing nothing of the port. It is held fixed
here, so a later change to the program cannot move the yardstick.

`world` builds a configuration's world; `episodes` replays a collection
dispatch's resets and actions from the generator state the dispatch drew
them from and steps a sample of its worlds; `decode_native` reads a native
barrel back."""
