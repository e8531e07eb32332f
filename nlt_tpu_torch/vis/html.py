"""Minimal HTML gallery generator for the per-epoch visualization pages
(a copy of nlt_tpu/vis/html.py)."""

import html as html_escape
import os


class Table:
    def __init__(self):
        self.rows = []

    def add_row(self, cells, types, captions=None):
        """cells: list of text strings or image paths; types: 'text' or
        'image' per cell; captions shown above each cell."""
        assert len(cells) == len(types)
        if captions is not None:
            assert len(captions) == len(cells)
        self.rows.append((cells, types, captions))

    def _render_cell(self, content, type_, caption):
        parts = ["<td style='padding:8px;vertical-align:top'>"]
        if caption:
            parts.append(
                "<div style='font-weight:bold;margin-bottom:4px'>%s</div>"
                % html_escape.escape(caption))
        if type_ == "image":
            parts.append(
                "<img src='%s' style='max-width:384px' loading='lazy'/>"
                % content)
        else:
            parts.append(
                "<pre style='max-width:384px;white-space:pre-wrap'>%s</pre>"
                % html_escape.escape(str(content)))
        parts.append("</td>")
        return "".join(parts)

    def render(self):
        out = ["<table border='1' style='border-collapse:collapse'>"]
        for cells, types, captions in self.rows:
            out.append("<tr>")
            for i, (content, type_) in enumerate(zip(cells, types)):
                cap = captions[i] if captions else None
                out.append(self._render_cell(content, type_, cap))
            out.append("</tr>")
        out.append("</table>")
        return "".join(out)


class HTML:
    def __init__(self, title=None, bgcolor="black", text_color="white"):
        self.title = title
        self.bgcolor = bgcolor
        self.text_color = text_color
        self.children = []

    def add_header(self, text):
        self.children.append(
            "<h1>%s</h1>" % html_escape.escape(text))

    def add_table(self):
        table = Table()
        self.children.append(table)
        return table

    def render(self):
        body = []
        if self.title:
            body.append("<h1>%s</h1>" % html_escape.escape(self.title))
        for child in self.children:
            body.append(
                child.render() if isinstance(child, Table) else child)
        return (
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>%s</title></head>"
            "<body style='background:%s;color:%s'>%s</body></html>"
            % (html_escape.escape(self.title or ""), self.bgcolor,
               self.text_color, "".join(body)))

    def save(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as h:
            h.write(self.render())
        return path
