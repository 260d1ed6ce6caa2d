"""Mitsuba XML scene parser -> builder dict.

Analog of the reference 3-stage parser (include/mitsuba/core/
parser.h:34-65: parse_file -> transform_all -> instantiate): here the XML is
lowered to the same dict vocabulary consumed by scene/builder.py, with
`<default>` declarations, `$var` substitution and `-D key=value` overrides
(mitsuba.cpp:243-249 CLI semantics).
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Any, Dict

import numpy as np

from .transform import Transform


def load_file(path: str, variant: str | None = None, **overrides):
    """Parse a Mitsuba XML scene and build it (mi.load_file analog).
    Keyword args override `<default>` parameter values; `variant`
    selects rgb (default) or spectral transport (builder.load_dict)."""
    from .builder import load_dict
    d = parse_xml(path, overrides)
    return load_dict(d, base_dir=os.path.dirname(os.path.abspath(path)),
                     variant=variant)


def parse_xml(path: str, overrides: Dict[str, Any] | None = None) -> dict:
    tree = ET.parse(path)
    root = tree.getroot()
    assert root.tag == "scene", "expected <scene> root"
    params: Dict[str, str] = {}
    for child in root.findall("default"):
        params[child.attrib["name"]] = child.attrib["value"]
    if overrides:
        params.update({k: str(v) for k, v in overrides.items()})

    def subst(s: str) -> str:
        def repl(mo):
            return params[mo.group(1)]
        return re.sub(r"\$(\w+)", repl, s)

    scene: Dict[str, Any] = {"type": "scene"}
    counter = [0]

    def add(d, key, val):
        if key in d:
            counter[0] += 1
            key = f"{key}_{counter[0]}"
        d[key] = val

    for child in root:
        if child.tag == "default":
            continue
        node = _convert(child, subst)
        if node is None:
            continue
        key, val = node
        add(scene, key, val)
    return scene


_SCALAR_TAGS = {"float": float, "integer": int, "boolean":
                lambda s: s.lower() == "true", "string": str}


def _parse_transform(el, subst) -> Transform:
    t = Transform()
    for op in el:
        a = {k: subst(v) for k, v in op.attrib.items()}
        if op.tag == "translate":
            t = Transform().translate(_vec3(a, 0.0)).matmul(t)
        elif op.tag == "scale":
            if "value" in a:
                v = [float(x) for x in re.split(r"[ ,]+", a["value"].strip())]
                v = v * 3 if len(v) == 1 else v
            else:
                v = _vec3(a, 1.0)
            t = Transform().scale(v).matmul(t)
        elif op.tag == "rotate":
            axis = _vec3(a, 0.0)
            t = Transform().rotate(axis, float(a["angle"])).matmul(t)
        elif op.tag == "lookat":
            def pv(s):
                return [float(x) for x in re.split(r"[ ,]+", s.strip())]
            t = Transform().look_at(pv(a["origin"]), pv(a["target"]),
                                    pv(a["up"])).matmul(t)
        elif op.tag == "matrix":
            # mitsuba accepts comma and/or whitespace separators (parser.cpp)
            vals = [float(x) for x in
                    subst(op.attrib["value"]).replace(",", " ").split()]
            m = np.asarray(vals).reshape(4, 4)
            t = Transform(m).matmul(t)
    return t


def _vec3(a: Dict[str, str], default: float):
    return [float(a.get("x", default)), float(a.get("y", default)),
            float(a.get("z", default))]


def _convert(el, subst):
    """Convert an element to (key, dict-or-scalar). Returns None to skip."""
    tag = el.tag
    attrib = {k: subst(v) for k, v in el.attrib.items()}
    name = attrib.get("name", attrib.get("id", tag))

    if tag in _SCALAR_TAGS:
        raw = attrib["value"]
        if tag == "float" and ":" in raw:
            raw = raw.split(":")[-1]   # legacy "lambda:value" tokens
        return name, _SCALAR_TAGS[tag](raw)
    if tag == "vector" or tag == "point":
        if "value" in attrib:
            v = [float(x) for x in re.split(r"[ ,]+", attrib["value"].strip())]
        else:
            v = _vec3(attrib, 0.0)
        return name, v
    if tag == "rgb":
        # tolerate legacy Mitsuba-0.6 "lambda:value" tokens (e.g. the
        # Parenchyma scene's sigma_* leftovers) by keeping the value part
        toks = [t.split(":")[-1]
                for t in re.split(r"[ ,]+", attrib["value"].strip()) if t]
        v = [float(x) for x in toks]
        if len(v) == 1:
            v = v * 3
        return name, {"type": "rgb", "value": v}
    if tag == "spectrum":
        raw = attrib.get("value", "")
        try:
            return name, {"type": "rgb", "value": [float(raw)] * 3}
        except ValueError:
            pass
        # "lambda:value, lambda:value, ..." irregular SPD (the bio media
        # coefficient tables, e.g. SphereLiverConstEnv sigma_blood);
        # silently defaulting these to 1.0 once made the parenchyma ball
        # render 10x too dark (absorber rates >> hepatocyte rate)
        pairs = []
        for t in re.split(r"[\s,]+", raw.strip()):
            if not t:
                continue
            lam, sep, v = t.partition(":")
            if not sep:
                pairs = None
                break
            try:
                pairs.append((float(lam), float(v)))
            except ValueError:
                pairs = None
                break
        if pairs and len(pairs) == 1:
            # a single (lambda, value) pair is a constant spectrum in
            # Mitsuba's parser, not a delta line
            return name, {"type": "rgb", "value": [pairs[0][1]] * 3}
        if pairs:
            return name, {"type": "irregular",
                          "wavelengths": [p[0] for p in pairs],
                          "values": [p[1] for p in pairs]}
        return name, {"type": "rgb", "value": [1.0, 1.0, 1.0]}
    if tag == "transform":
        return name, _parse_transform(el, subst)
    if tag == "ref":
        return attrib.get("name", f"ref_{attrib['id']}"), \
            {"type": "ref", "id": attrib["id"]}

    # object tags: integrator, sensor, film, sampler, bsdf, shape, emitter,
    # medium, phase, texture, rfilter, volume ...
    # the fork's scenes carry a few Initial-Capitalized plugin names
    # ("Dielectric", SphereLiverPoint/mitsuba3) that stock Mitsuba would
    # reject; normalize just the initial (camelCase types like
    # glissonCapsule are canonical)
    _t = attrib.get("type", tag)
    d: Dict[str, Any] = {"type": _t[:1].lower() + _t[1:]}
    if "id" in attrib:
        d["id"] = attrib["id"]
    cnt = 0
    for child in el:
        node = _convert(child, subst)
        if node is None:
            continue
        key, val = node
        # nested objects keep their canonical slot names
        if child.tag in ("bsdf", "film", "sampler", "rfilter", "phase",
                         "emitter", "medium", "texture", "volume"):
            key = child.attrib.get("name", child.tag)
            if child.tag == "medium" and key not in ("interior", "exterior"):
                key = "interior"
            if child.tag == "rfilter":
                _rt = child.attrib["type"]
                val = {"type": _rt[:1].lower() + _rt[1:]}
        if key in d:
            cnt += 1
            key = f"{key}_{cnt}"
        d[key] = val
    key = attrib.get("id", tag)
    return key, d
