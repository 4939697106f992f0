"""Execution engines: the HEALPix shell runners."""

from . import HealpixRunner
from .HealpixRunner import DefaultRunner, BaryonifyShell, PaintProfilesShell
