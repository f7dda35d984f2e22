"""Self-contained image-gallery page for tool output directories (copy of
``ganspace_tpu/tools/lightbox.py``; reference ``netdissect/tool/lightbox.html``
+ ``makesample.copy_lightbox_to``, ``tool/makesample.py:158-162``).

The reference ships a Vue page that pulls four CDN scripts and scrapes an
Apache directory listing at view time.  The page has to work offline and
the image set is known when the tool finishes, so the equivalent is a
static page with the filenames embedded at write time and a dependency-free
click-to-enlarge overlay — it works from file:// as well as any dumb file
server.

    python -m ganspace_tpu_torch.tools.lightbox OUTDIR [--title ...]
"""

from __future__ import annotations

import argparse
import html
import json
from pathlib import Path
from typing import Iterable, Optional

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".gif", ".webp")

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font-family: sans-serif; background: #181818; color: #ddd; margin: 16px; }}
.thumb {{ display: inline-block; margin: 2px; text-align: center;
          font-size: 11px; vertical-align: top; }}
.thumb img {{ max-width: 150px; display: block; cursor: zoom-in; }}
#overlay {{ position: fixed; inset: 0; background: rgba(0,0,0,.85);
            display: none; align-items: center; justify-content: center;
            cursor: zoom-out; flex-direction: column; }}
#overlay img {{ max-width: 95vw; max-height: 90vh; }}
#overlay div {{ color: #ddd; padding: 6px; }}
</style></head><body>
<h3>{title} — {count} images</h3>
<div id="grid"></div>
<div id="overlay" onclick="this.style.display='none'">
  <img id="big"/><div id="cap"></div>
</div>
<script>
var images = {images_json};
var grid = document.getElementById('grid');
images.forEach(function (name) {{
  var d = document.createElement('div'); d.className = 'thumb';
  var img = document.createElement('img'); img.src = name; img.loading = 'lazy';
  img.onclick = function () {{
    document.getElementById('big').src = name;
    document.getElementById('cap').textContent = name;
    document.getElementById('overlay').style.display = 'flex';
  }};
  var cap = document.createElement('div'); cap.textContent = name;
  d.appendChild(cap); d.appendChild(img); grid.appendChild(d);
}});
</script></body></html>
"""


def write_lightbox(dirname, title: Optional[str] = None,
                   images: Optional[Iterable[str]] = None) -> Path:
    """Write ``+lightbox.html`` into ``dirname`` listing its images.

    ``images`` overrides the directory scan (relative names, shown in the
    given order); by default every image file in ``dirname`` is listed in
    sorted order.  Returns the page path.
    """
    d = Path(dirname)
    if images is None:
        images = sorted(p.name for p in d.iterdir()
                        if p.suffix.lower() in IMAGE_SUFFIXES)
    else:
        images = list(images)
    page = _PAGE.format(title=html.escape(title or d.name),
                        count=len(images), images_json=json.dumps(images))
    out = d / "+lightbox.html"
    out.write_text(page)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ganspace_tpu_torch.tools.lightbox")
    p.add_argument("dir", help="directory of images")
    p.add_argument("--title", default=None)
    args = p.parse_args(argv)
    out = write_lightbox(args.dir, title=args.title)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
