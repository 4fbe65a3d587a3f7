"""Optional interactive viewer (the port of boxlcd_tpu/viewer.py; reference:
boxLCD/viewer.py).

Host-side visualization only. When pyglet (and a display) is available,
`Viewer` blits RGB frames into a window as the reference does; without
them `ArrayViewer` records the frames instead, so the same calling code
works everywhere (`WorldEnv.render('human')` uses whichever is available).
pyglet is optional and imported only when a window is opened; without it
`HAVE_PYGLET` is False and `make_viewer` gives the `ArrayViewer`.
"""
from __future__ import annotations

import importlib.util

import numpy as np

HAVE_PYGLET = importlib.util.find_spec('pyglet') is not None


class ArrayViewer:
  """Headless drop-in: keeps the most recent frames instead of a window."""

  def __init__(self, width, height, G=None, keep=64):
    self.width = width
    self.height = height
    self.G = G
    self.frames = []
    self._keep = keep

  def render(self, image, return_rgb_array=False):
    self.frames.append(np.asarray(image))
    if len(self.frames) > self._keep:
      self.frames.pop(0)
    return np.asarray(image) if return_rgb_array else None

  def close(self):
    self.frames.clear()


class Viewer:
  """pyglet window blitting pre-rendered RGB arrays
  (reference: viewer.py:4-37)."""

  def __init__(self, width, height, G=None):
    if not HAVE_PYGLET:
      raise RuntimeError('pyglet not available; use ArrayViewer')
    import pyglet
    self.pyglet = pyglet
    self.window = pyglet.window.Window(2 * width, height)
    self.width = width
    self.height = height
    self.G = G

  def render(self, image, return_rgb_array=False):
    image = np.ascontiguousarray(image, np.uint8)
    self.window.clear()
    self.window.switch_to()
    self.window.dispatch_events()
    pyglet = self.pyglet
    img = pyglet.image.ImageData(image.shape[1], image.shape[0], 'RGB',
                                 image.tobytes(), pitch=image.shape[1] * -3)
    img.blit(0, 0)
    arr = None
    if return_rgb_array:
      buffer = pyglet.image.get_buffer_manager().get_color_buffer()
      image_data = buffer.get_image_data()
      arr = np.frombuffer(image_data.get_data(), dtype=np.uint8)
      arr = arr.reshape(buffer.height, buffer.width, 4)[::-1, :, 0:3]
    self.window.flip()
    return arr

  def close(self):
    self.window.close()


def make_viewer(width, height, G=None):
  """The interactive viewer when possible, else the recording fallback."""
  if HAVE_PYGLET:
    try:
      return Viewer(width, height, G)
    except Exception as e:  # no display or no GL context
      print(f'pyglet window unavailable ({e}); recording frames instead')
  return ArrayViewer(width, height, G)
