"""`python -m pcd_reg_hregnet_torch {train,eval,infer,pretrain-feats,visualize}` (`cli.py`)."""
from .cli import main

if __name__ == '__main__':
    raise SystemExit(main())
