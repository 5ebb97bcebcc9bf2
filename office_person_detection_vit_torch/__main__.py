"""``python -m office_person_detection_vit_torch --config config.yaml``: the
port's pipeline (``main.main``)."""

import sys

from .main import main

sys.exit(main())
