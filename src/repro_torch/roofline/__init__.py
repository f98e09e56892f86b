from repro_torch.roofline.analysis import (  # noqa: F401
    HW_H100, collective_record, format_row, model_flops, roofline_report)
