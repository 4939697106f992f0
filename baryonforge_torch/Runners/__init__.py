"""Execution engines: the HEALPix shell runners, the Cartesian grid runners
and the particle snapshot runner."""

from . import HealpixRunner
from . import Map2DRunner
from . import SnapshotRunner
from .HealpixRunner import (DefaultRunner, BaryonifyShell, PaintProfilesShell,
                            PaintProfilesAnisShell)
from .Map2DRunner import (DefaultRunnerGrid, BaryonifyGrid, PaintProfilesGrid,
                          PaintProfilesAnisGrid)
from .SnapshotRunner import DefaultRunnerSnapshot, BaryonifySnapshot
