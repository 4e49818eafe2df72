"""Static HTML gallery writer (reference util/html.py, without the dominate
dependency): collects images + captions into an index page for browsing exported
keypoint renderings (counterpart of ``usip_tpu/utils/html.py``; the port keeps
its own copy, the same bytes out)."""

from __future__ import annotations

import html
import os
from typing import List, Optional, Tuple


class HTMLGallery:
    def __init__(self, out_dir: str, title: str = "usip_tpu results",
                 image_dir: str = "images"):
        self.out_dir = out_dir
        self.title = title
        self.image_dir = image_dir
        os.makedirs(os.path.join(out_dir, image_dir), exist_ok=True)
        self._sections: List[Tuple[str, List[Tuple[str, str]]]] = []

    def image_path(self, name: str) -> str:
        """Absolute path to save an image so the gallery can reference it."""
        return os.path.join(self.out_dir, self.image_dir, name)

    def add_section(self, header: str, images: List[Tuple[str, str]]):
        """images: list of (relative image filename, caption)."""
        self._sections.append((header, images))

    def save(self, filename: str = "index.html") -> str:
        parts = [
            "<!doctype html><html><head><meta charset='utf-8'>",
            f"<title>{html.escape(self.title)}</title>",
            "<style>body{font-family:sans-serif;margin:2em}"
            ".row{display:flex;flex-wrap:wrap;gap:12px}"
            ".cell{text-align:center;font-size:12px}"
            "img{max-width:320px;border:1px solid #ccc}</style></head><body>",
            f"<h1>{html.escape(self.title)}</h1>",
        ]
        for header, images in self._sections:
            parts.append(f"<h2>{html.escape(header)}</h2><div class='row'>")
            for fn, caption in images:
                src = html.escape(fn) if not self.image_dir \
                    else f"{self.image_dir}/{html.escape(fn)}"
                parts.append(
                    f"<div class='cell'><a href='{src}'><img src='{src}'></a>"
                    f"<div>{html.escape(caption)}</div></div>")
            parts.append("</div>")
        parts.append("</body></html>")
        path = os.path.join(self.out_dir, filename)
        with open(path, "w") as f:
            f.write("\n".join(parts))
        return path
