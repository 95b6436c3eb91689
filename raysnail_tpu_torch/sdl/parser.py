"""Recursive-descent parser for the reference's PovRay SDL subset
(src/sdl_parser.rs:187-1402), producing scene-IR specs instead of trait
objects.

Grammar (keywords at sdl_parser.rs:207-261):
  statement   := camera | light | sphere | box | quadric | object
               | difference | intersection | #declare | #while | #end
  camera      := 'camera' '{' (location <v> | look_at <v> | angle e)* '}'
  light       := 'light' '{' <v> ',' color rgb <v> '}'
  sphere      := 'sphere' '{' <v> ',' e texture? modifiers* '}'
  box         := 'box' '{' <v> ',' <v> texture? modifiers* '}'
  quadric     := 'quadric' '{' <A,E,H> ',' <B,C,F> ',' <D,G,I> ',' J
                 texture? modifiers* '}'    (coefficient packing at :660)
  object      := 'object' '{' IDENT modifiers* '}'   (clones a #declare)
  difference / intersection := op '{' statement statement texture? modifiers* '}'
  modifiers   := translate <v> | rotate <deg3> | scale (<v>|e)
  texture     := 'texture' '{' pigment? (finish | surface)? '}'
  #while      := '#while' '(' e '<' e ')' ... '#end'  (loop by token rewind,
                 sdl_parser.rs:854-918 — '<' is the only comparison)

Expressions are the full +,-,*,/ precedence grammar with parentheses, unary
minus, and #declared identifiers (sdl_parser.rs:1256-1402).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.geometry import transforms as tf

KEYWORDS = {
    "camera", "location", "look_at", "angle", "sphere", "box", "quadric",
    "light", "intersection", "difference", "object", "texture", "pigment",
    "finish", "surface", "metallic", "reflection", "color", "rgb", "diffuse",
    "phong", "phong_size", "checker", "translate", "rotate", "scale",
    "#declare", "#while", "#end",
}
SEPARATORS = " ,;()<>{}+-*/="


@dataclasses.dataclass
class Token:
    text: str
    line: int


@dataclasses.dataclass
class CameraData:
    location: tuple = (0.0, 0.0, 0.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    fov_angle: float = 60.0


@dataclasses.dataclass
class LightData:
    location: tuple
    color: tuple


@dataclasses.dataclass
class SceneData:
    camera: Optional[CameraData]
    objects: list
    lights: list


_MATERIAL_TYPES = (ir.Lambertian, ir.Metal, ir.DiffuseMetal, ir.Dielectric,
                   ir.BlinnPhong, ir.DiffuseLight, ir.Isotropic, ir.Mixed)


class ParseError(Exception):
    pass


def tokenize(text: str) -> list[Token]:
    """Line-based tokenizer: strip //-comments, split on separators
    inclusively (sdl_parser.rs:272-330)."""
    tokens = []
    for line_no, line in enumerate(text.splitlines(), 1):
        if "//" in line:
            line = line[: line.index("//")]
        cur = ""
        for ch in line:
            if ch in SEPARATORS:
                if cur:
                    tokens.append(Token(cur, line_no))
                    cur = ""
                if ch != " ":
                    tokens.append(Token(ch, line_no))
            else:
                cur += ch
        if cur:
            tokens.append(Token(cur, line_no))
    return tokens


class SdlParser:
    """Parse an SDL file to SceneData of IR specs."""

    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.pos = 0
        self.declares: dict = {}
        self.loops: list[int] = []

    # -- plumbing ----------------------------------------------------------

    @classmethod
    def parse(cls, filename: str) -> SceneData:
        with open(filename) as f:
            return cls.parse_string(f.read())

    @classmethod
    def parse_string(cls, text: str) -> SceneData:
        p = cls(tokenize(text))
        return p.parse_root()

    @property
    def current(self) -> str:
        return self.tokens[self.pos].text if self.pos < len(self.tokens) else "<eof>"

    @property
    def line(self) -> int:
        return self.tokens[self.pos].line if self.pos < len(self.tokens) else -1

    def advance(self):
        self.pos += 1

    def accept(self, text: str) -> bool:
        if self.current == text:
            self.advance()
            return True
        return False

    def expect(self, text: str):
        if not self.accept(text):
            raise ParseError(f"line {self.line}: expected '{text}', found '{self.current}'")

    def fail(self, msg: str):
        raise ParseError(f"line {self.line}: {msg} (found '{self.current}')")

    # -- root --------------------------------------------------------------

    def parse_root(self) -> SceneData:
        scene = SceneData(camera=None, objects=[], lights=[])
        while self.pos < len(self.tokens):
            kind, value = self.parse_statement()
            if kind == "camera":
                scene.camera = value
            elif kind == "light":
                scene.lights.append(value)
            elif kind == "object":
                scene.objects.append(value)
            # directives contribute nothing
        return scene

    def parse_statement(self):
        """-> (kind, value): kind in {'camera','light','object','directive'}."""
        t = self.current
        if t == "camera":
            return "camera", self.parse_camera()
        if t == "light":
            return "light", self.parse_light()
        if t == "sphere":
            return "object", self.parse_sphere()
        if t == "box":
            return "object", self.parse_box()
        if t == "quadric":
            return "object", self.parse_quadric()
        if t == "object":
            return "object", self.parse_object()
        if t == "difference":
            return "object", self.parse_csg("difference")
        if t == "intersection":
            return "object", self.parse_csg("intersection")
        if t == "#declare":
            return "directive", self.parse_declare()
        if t == "#while":
            return "directive", self.parse_while()
        if t == "#end":
            return "directive", self.parse_end()
        self.fail("invalid statement")

    # -- productions -------------------------------------------------------

    def parse_camera(self) -> CameraData:
        self.expect("camera")
        self.expect("{")
        cam = CameraData()
        while not self.accept("}"):
            if self.accept("location"):
                cam.location = self.parse_vector()
            elif self.accept("look_at"):
                cam.look_at = self.parse_vector()
            elif self.accept("angle"):
                cam.fov_angle = self.parse_expression()
            else:
                self.fail("expected camera item")
        return cam

    def parse_light(self) -> LightData:
        self.expect("light")
        self.expect("{")
        loc = self.parse_vector()
        self.accept(",")
        color = self.parse_color()
        if color is None:
            self.fail("expected light color")
        self.expect("}")
        return LightData(location=loc, color=color)

    def parse_color(self):
        """'color' ['rgb'] <v> (sdl_parser.rs pigment/light color).
        EXTENSION over the reference grammar: a #declare'd vector identifier
        may stand in for the <v> literal ('color rgb MyColor')."""
        if self.accept("color"):
            self.accept("rgb")
            if self.current != "<" and self.current in self.declares \
                    and isinstance(self.declares[self.current], tuple):
                v = self.declares[self.current]
                self.advance()
                return v
            return self.parse_vector()
        return None

    def parse_sphere(self) -> ir.Sphere:
        self.expect("sphere")
        self.expect("{")
        center = self.parse_vector()
        self.accept(",")
        radius = self.parse_expression()
        material = self.parse_texture()
        transform = self.parse_modifiers()
        self.expect("}")
        return ir.Sphere(center, radius, material, transform=transform)

    def parse_box(self) -> ir.Box:
        self.expect("box")
        self.expect("{")
        p0 = self.parse_vector()
        self.accept(",")
        p1 = self.parse_vector()
        material = self.parse_texture()
        transform = self.parse_modifiers()
        self.expect("}")
        # normalize corner ordering for the slab test
        lo = tuple(min(a, b) for a, b in zip(p0, p1))
        hi = tuple(max(a, b) for a, b in zip(p0, p1))
        return ir.Box(lo, hi, material, transform=transform)

    def parse_quadric(self) -> ir.Quadric:
        self.expect("quadric")
        self.expect("{")
        v1 = self.parse_vector()  # <A, E, H>
        self.accept(",")
        v2 = self.parse_vector()  # <B, C, F>
        self.accept(",")
        v3 = self.parse_vector()  # <D, G, I>
        self.accept(",")
        j = self.parse_expression()
        material = self.parse_texture()
        transform = self.parse_modifiers()
        self.expect("}")
        coeffs = (v1[0], v2[0], v2[1], v3[0], v1[1], v2[2], v3[1], v1[2], v3[2], j)
        return ir.Quadric(coeffs, material, transform=transform)

    def parse_object(self):
        """'object' '{' IDENT modifiers* '}' — instantiates a #declare'd
        hittable with extra transforms stacked on top (sdl_parser.rs:678-720)."""
        self.expect("object")
        self.expect("{")
        ident = self.current
        self.advance()
        transform = self.parse_modifiers()
        self.expect("}")
        if ident not in self.declares:
            self.fail(f"undeclared identifier '{ident}'")
        proto = self.declares[ident]
        if not dataclasses.is_dataclass(proto):
            self.fail(f"'{ident}' is not an object")
        if transform is not None:
            existing = ir.unmat4(proto.transform) if proto.transform else np.eye(4)
            combined = ir.mat4(ir.unmat4(transform) @ existing)
            proto = dataclasses.replace(proto, transform=combined)
        return proto

    def parse_csg(self, op: str) -> ir.Csg:
        self.expect(op)
        self.expect("{")
        _, left = self.parse_statement()
        _, right = self.parse_statement()
        material = self.parse_texture()
        transform = self.parse_modifiers()
        self.expect("}")
        return ir.Csg(op=op, left=left, right=right, material=material,
                      transform=transform)

    def parse_declare(self):
        self.expect("#declare")
        ident = self.current
        self.advance()
        self.expect("=")
        # EXTENSIONS over the reference (rs:814-851 supports only
        # float/vector/statement): '#declare N = texture {...};' and
        # '#declare N = color rgb <...>;'
        if self.current == "texture":
            self.declares[ident] = self.parse_texture()
            self.accept(";")
            return "#declare"
        if self.current == "color":
            self.declares[ident] = tuple(self.parse_color())
            self.accept(";")
            return "#declare"
        # scalar expression first, then vector, then statement (rs:814-851)
        save = self.pos
        try:
            v = self.parse_expression()
            self.accept(";")
            self.declares[ident] = v
            return "#declare"
        except ParseError:
            self.pos = save
        if self.current == "<":
            v = self.parse_vector()
            self.accept(";")
            self.declares[ident] = v
            return "#declare"
        _, entity = self.parse_statement()
        self.declares[ident] = entity
        return "#declare"

    def parse_while(self):
        """'#while' '(' e '<' e ')' — on true, remember the loop start; on
        false, skip to after '#end' (rs:854-918). Loops run by re-parsing."""
        loop_start = self.pos
        self.expect("#while")
        self.expect("(")
        v1 = self.parse_expression()
        self.expect("<")
        v2 = self.parse_expression()
        self.accept(")")
        if v1 < v2:
            self.loops.append(loop_start)
        else:
            while self.current != "#end":
                if self.pos >= len(self.tokens):
                    self.fail("unterminated #while")
                self.advance()
            self.advance()
        return "#while"

    def parse_end(self):
        self.expect("#end")
        if not self.loops:
            self.fail("#end without #while")
        self.pos = self.loops.pop()
        return "#end"

    # -- texture / material ------------------------------------------------

    def parse_texture(self) -> Optional[ir.MaterialSpec]:
        """texture { pigment? (finish|surface)? } (rs:967-1100).
        EXTENSION: 'texture { Name }' instantiates a #declare'd texture."""
        if not self.accept("texture"):
            return None
        self.expect("{")
        if self.current in self.declares and isinstance(
                self.declares[self.current], _MATERIAL_TYPES):
            material = self.declares[self.current]
            self.advance()
            self.expect("}")
            return material
        texture = self.parse_pigment()
        if texture is None:
            texture = ir.Constant((1.0, 1.0, 1.0))
        material = self.parse_finish(texture)
        self.expect("}")
        return material

    def parse_pigment(self):
        if not self.accept("pigment"):
            return None
        self.expect("{")
        color = self.parse_color()
        if color is not None:
            self.expect("}")
            return ir.Constant(color)
        if self.accept("checker"):
            c1 = self.parse_color()
            self.accept(",")
            c2 = self.parse_color()
            self.expect("}")
            # checker scale fixed to 2.0 (rs:1005)
            return ir.Checker(ir.Constant(c1), ir.Constant(c2), 2.0)
        self.fail("expected pigment color or checker")

    def parse_finish(self, texture) -> ir.MaterialSpec:
        """finish{reflection|phong|phong_size} -> Lambertian or
        Mixed(Metal, Lambertian, reflection); surface{metallic [diffuse e]}
        -> Metal / DiffuseMetal (rs:1015-1100)."""
        if self.accept("finish"):
            self.expect("{")
            phong, phong_size, reflection = 0.0, 40.0, 0.0
            while True:
                if self.accept("reflection"):
                    reflection = self.parse_expression()
                elif self.accept("phong"):
                    phong = self.parse_expression()
                elif self.accept("phong_size"):
                    phong_size = self.parse_expression()
                else:
                    break
            self.expect("}")
            pf, pe = _settings(phong, phong_size)
            lam = ir.Lambertian(texture, phong_factor=pf, phong_exponent=pe)
            if reflection == 0.0:
                return lam
            metal = ir.Metal(texture, phong_factor=pf, phong_exponent=pe)
            return ir.Mixed(metal, lam, reflection)
        if self.accept("surface"):
            self.expect("{")
            if self.accept("metallic"):
                if self.accept("diffuse"):
                    v = self.parse_expression()
                    mat = ir.DiffuseMetal(v, texture)
                else:
                    mat = ir.Metal(texture)
            else:
                mat = ir.Lambertian(texture)
            self.expect("}")
            return mat
        return ir.Lambertian(texture)

    # -- modifiers ---------------------------------------------------------

    def parse_modifiers(self) -> Optional[tuple]:
        """translate/rotate/scale* -> combined forward matrix (rs:930-965);
        rotate spawns one stack entry per NON-ZERO axis, x then y then z in
        degrees (rs:940-954)."""
        stack = []
        while True:
            if self.accept("translate"):
                stack.append(tf.translate(self.parse_vector()))
            elif self.accept("rotate"):
                v = self.parse_vector()
                if v[0] != 0.0:
                    stack.append(tf.rotate_x(math.radians(v[0])))
                if v[1] != 0.0:
                    stack.append(tf.rotate_y(math.radians(v[1])))
                if v[2] != 0.0:
                    stack.append(tf.rotate_z(math.radians(v[2])))
            elif self.accept("scale"):
                if self.current == "<":
                    stack.append(tf.scale(self.parse_vector()))
                else:
                    stack.append(tf.scale(self.parse_expression()))
            else:
                break
        if not stack:
            return None
        return ir.mat4(tf.compose(stack))

    # -- expressions (rs:1234-1402) -----------------------------------------

    def parse_vector(self) -> tuple:
        self.expect("<")
        e1 = self.parse_expression()
        self.accept(",")
        e2 = self.parse_expression()
        self.accept(",")
        e3 = self.parse_expression()
        self.expect(">")
        return (e1, e2, e3)

    def parse_expression(self) -> float:
        v = self.parse_term()
        while True:
            if self.accept("+"):
                v = v + self.parse_term()
            elif self.accept("-"):
                v = v - self.parse_term()
            else:
                return v

    def parse_term(self) -> float:
        v = self.parse_factor()
        while True:
            if self.accept("*"):
                v = v * self.parse_factor()
            elif self.accept("/"):
                v = v / self.parse_factor()
            else:
                return v

    def parse_factor(self) -> float:
        if self.accept("-"):
            return -self.parse_factor()
        if self.accept("("):
            v = self.parse_expression()
            self.expect(")")
            return v
        t = self.current
        try:
            v = float(t)
            self.advance()
            return v
        except ValueError:
            pass
        if t in self.declares and isinstance(self.declares[t], (int, float)):
            self.advance()
            return float(self.declares[t])
        raise ParseError(f"line {self.line}: expected number, found '{t}'")


def _settings(phong: float, phong_size: float):
    """phong_factor = phong*4, phong_exponent = int(phong_size*0.1)
    (sdl_parser.rs:1091-1100)."""
    if phong > 0.0:
        return phong * 4.0, float(int(phong_size * 0.1))
    return 0.0, 1.0
