"""Execution engines: the HEALPix shell runner (scatter path)."""

from . import HealpixRunner
from .HealpixRunner import DefaultRunner, BaryonifyShell
