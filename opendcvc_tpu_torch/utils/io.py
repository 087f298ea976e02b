"""Video/image IO: PNG sequences and raw planar YUV420 files
(reference: src/utils/video_reader.py, video_writer.py).

The port's copy of the JAX package's `utils/io.py`.  PIL is imported by the
PNG classes on first use, so a YUV420 run never needs it.
"""

import os

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PNG sequences need PIL (the Pillow package); "
                          "raw YUV420 sequences do not") from e
    return Image


class PNGReader:
    """Reads im1.png / im00001.png style sequences as (3,H,W) uint8."""

    def __init__(self, src_path, width, height, start_num=1):
        self.eof = False
        self.src_path = src_path
        self.width = width
        self.height = height
        pngs = os.listdir(self.src_path)
        if "im1.png" in pngs:
            self.padding = 1
        elif "im00001.png" in pngs:
            self.padding = 5
        else:
            raise ValueError("unknown image naming convention")
        self.current_frame_index = start_num

    def read_one_frame(self):
        if self.eof:
            return None
        png_path = os.path.join(
            self.src_path,
            f"im{str(self.current_frame_index).zfill(self.padding)}.png")
        if not os.path.exists(png_path):
            self.eof = True
            return None
        with _pil_image().open(png_path) as im:
            rgb = np.asarray(im.convert("RGB"))
        rgb = rgb.astype(np.uint8).transpose(2, 0, 1)
        _, height, width = rgb.shape
        if (height, width) != (self.height, self.width):
            raise ValueError(f"{png_path} is {width}x{height}, not "
                             f"{self.width}x{self.height}")
        self.current_frame_index += 1
        return rgb

    def close(self):
        self.current_frame_index = 1


class YUV420Reader:
    """Raw planar YUV420: y (1,H,W), uv (2,H/2,W/2) uint8 per frame."""

    def __init__(self, src_path, width, height, skip_frame=0):
        self.eof = False
        if not src_path.endswith(".yuv"):
            src_path = src_path + ".yuv"
        self.src_path = src_path
        self.y_size = width * height
        self.y_width = width
        self.y_height = height
        self.uv_size = width * height // 2
        self.uv_width = width // 2
        self.uv_height = height // 2
        self.file = open(src_path, "rb")
        skipped = 0
        while not self.eof and skipped < skip_frame:
            y = self.file.read(self.y_size)
            uv = self.file.read(self.uv_size)
            if not y or not uv:
                self.eof = True
            skipped += 1

    def read_one_frame(self):
        if self.eof:
            return None, None
        y = self.file.read(self.y_size)
        uv = self.file.read(self.uv_size)
        if not y or not uv:
            self.eof = True
            return None, None
        y = np.frombuffer(y, dtype=np.uint8).copy().reshape(
            1, self.y_height, self.y_width)
        uv = np.frombuffer(uv, dtype=np.uint8).copy().reshape(
            2, self.uv_height, self.uv_width)
        return y, uv

    def close(self):
        self.file.close()


class PNGWriter:
    def __init__(self, dst_path, width, height):
        self.dst_path = dst_path
        self.width = width
        self.height = height
        self.padding = 5
        self.current_frame_index = 1
        os.makedirs(dst_path, exist_ok=True)

    def write_one_frame(self, rgb):
        """rgb: (3,H,W) uint8."""
        rgb = rgb.transpose(1, 2, 0)
        png_path = os.path.join(
            self.dst_path,
            f"im{str(self.current_frame_index).zfill(self.padding)}.png")
        _pil_image().fromarray(rgb).save(png_path)
        self.current_frame_index += 1

    def close(self):
        self.current_frame_index = 1


class YUV420Writer:
    def __init__(self, dst_path, width, height):
        if not dst_path.endswith(".yuv"):
            dst_path = dst_path + "/out.yuv"
        self.dst_path = dst_path
        self.width = width
        self.height = height
        self.file = open(dst_path, "wb")

    def write_one_frame(self, y, uv):
        self.file.write(y.tobytes())
        self.file.write(uv.tobytes())

    def close(self):
        self.file.close()
