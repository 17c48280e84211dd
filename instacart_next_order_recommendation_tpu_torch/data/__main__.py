from instacart_next_order_recommendation_tpu_torch.data.prepare import main

raise SystemExit(main())
